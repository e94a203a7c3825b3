"""The port's irreps algebra (``irreps.py``), spherical harmonics
(``ops/spherical.py``) and ``ops/norms.safe_normalize`` against the JAX
package's, plus the golden identities of ``tests/test_e3nn_golden.py`` on
the port's copies.  CG and Wigner tensors are float64 numpy on both sides:
within 1e-12.  SH in float32: within 1e-6."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ortho_group

from geometric_message_passing_tpu import irreps as jir
from geometric_message_passing_tpu.ops import norms as jnorms
from geometric_message_passing_tpu.ops import spherical as jsph
from geometric_message_passing_tpu_torch import irreps as tir
from geometric_message_passing_tpu_torch.ops import norms as tnorms
from geometric_message_passing_tpu_torch.ops import spherical as tsph

LS = [(a, b, c) for a in range(4) for b in range(4)
      for c in range(abs(a - b), min(a + b, 4) + 1)]


@pytest.mark.parametrize("l1,l2,l3", LS)
def test_wigner_3j_and_cg_match_jax(l1, l2, l3):
    np.testing.assert_allclose(tir._su2_cg(l1, l2, l3),
                               jir._su2_cg(l1, l2, l3), atol=1e-12)
    np.testing.assert_allclose(tir.wigner_3j(l1, l2, l3),
                               jir.wigner_3j(l1, l2, l3), atol=1e-12)


def test_cg_outside_the_triangle_is_zero():
    assert not tir._su2_cg(1, 1, 3).any()
    np.testing.assert_allclose(tir.sh_basis_change_matrix(3),
                               jir.sh_basis_change_matrix(3))


@pytest.mark.parametrize("spec", ["64x0e", "8x0e+8x1o+8x2e+8x3o",
                                  "2x0e+1x1o+3x2e", "1x1o+1x0e+2x1o"])
def test_irreps_algebra_matches_jax(spec):
    t, j = tir.Irreps(spec), jir.Irreps(spec)
    assert repr(t) == repr(j)
    assert (t.dim, t.num_irreps, t.lmax, t.ls) == (j.dim, j.num_irreps,
                                                   j.lmax, j.ls)
    assert repr(t.sort().simplify()) == repr(j.sort().simplify())
    assert [(s.start, s.stop) for s in t.slices()] == [
        (s.start, s.stop) for s in j.slices()]
    assert repr(t * 3) == repr(j * 3) and t.count("0e") == j.count("0e")
    assert repr(tir.Irreps.spherical_harmonics(3)) == repr(
        jir.Irreps.spherical_harmonics(3))


@pytest.mark.parametrize("ins,sh,out", [
    ("8x0e", "1x0e+1x1o+1x2e+1x3o",
     "8x0e+24x0e+8x1o+8x2e+8x3o"),
    ("8x0e+8x1o+8x2e+8x3o", "1x0e+1x1o+1x2e+1x3o",
     "8x0e+24x0e+8x1o+8x2e+8x3o"),
    ("2x0e+1x1o", "1x0e+1x1o", "3x0e+2x1o+1x1e")])
def test_tp_paths_match_jax(ins, sh, out):
    t = tir.tp_paths(tir.Irreps(ins), tir.Irreps(sh), tir.Irreps(out))
    j = jir.tp_paths(jir.Irreps(ins), jir.Irreps(sh), jir.Irreps(out))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert (a.i_in1, a.i_in2, a.i_out, a.mul_in1, a.mul_in2, a.mul_out,
                repr(a.ir_in1), repr(a.ir_in2), repr(a.ir_out)) == (
            b.i_in1, b.i_in2, b.i_out, b.mul_in1, b.mul_in2, b.mul_out,
            repr(b.ir_in1), repr(b.ir_in2), repr(b.ir_out))
        assert a.path_weight == pytest.approx(b.path_weight, abs=1e-15)


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_wigner_d_matches_jax_and_intertwines(l):
    R = ortho_group.rvs(3, random_state=l)
    det = float(np.sign(np.linalg.det(R)))
    np.testing.assert_allclose(tir.wigner_D_from_matrix(l, R * det),
                               jir.wigner_D_from_matrix(l, R * det), atol=1e-12)
    irreps = "1x0e+2x1o+1x2e+1x3o"
    np.testing.assert_allclose(
        tir.irreps_rep(tir.Irreps(irreps), R, det),
        jir.irreps_rep(jir.Irreps(irreps), R, det), atol=1e-12)
    if l:
        D1, Dl = (tir.wigner_D_from_matrix(k, R * det) for k in (1, l))
        C = tir.wigner_3j(1, l, l)
        np.testing.assert_allclose(np.einsum("ai,bj,ijk->abk", D1, Dl, C),
                                   np.einsum("abj,jk->abk", C, Dl), atol=1e-10)


# --- golden identities (tests/test_e3nn_golden.py), on the port's copies ---


def test_golden_w3j_000_and_scalar_coupling():
    np.testing.assert_allclose(tir.wigner_3j(0, 0, 0), np.ones((1, 1, 1)))
    for l in (1, 2, 3):
        C = tir.wigner_3j(0, l, l)[0]
        d = 2 * l + 1
        np.testing.assert_allclose(np.abs(C), np.eye(d) / math.sqrt(d),
                                   atol=1e-12)
        np.testing.assert_allclose(np.diag(C), np.diag(C)[0], atol=1e-12)


def test_golden_w3j_111_levi_civita_and_unit_norm():
    C = tir.wigner_3j(1, 1, 1)
    eps = np.zeros((3, 3, 3))
    for i, j, k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
        eps[i, j, k] = eps[j, i, k] = 1
    np.testing.assert_allclose(np.abs(C), eps / math.sqrt(6), atol=1e-12)
    np.testing.assert_allclose(C, -np.swapaxes(C, 0, 1), atol=1e-12)
    for lll in [(1, 1, 2), (2, 2, 2), (1, 2, 3), (2, 3, 1)]:
        np.testing.assert_allclose(np.linalg.norm(tir.wigner_3j(*lll)), 1.0,
                                   atol=1e-12)


# --- spherical harmonics and safe_normalize ---


def _vectors(n=40, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    v[3] = 0.0          # a pad edge
    return v


@pytest.mark.parametrize("lmax", [1, 2, 3, 4])
def test_spherical_harmonics_match_jax(lmax):
    v = _vectors()
    want = np.asarray(jsph.spherical_harmonics(jnp.asarray(v), lmax))
    got = tsph.spherical_harmonics(torch.from_numpy(v), lmax).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert tsph.sh_normalization_constants(lmax) == pytest.approx(
        jsph.sh_normalization_constants(lmax), abs=1e-14)
    # component normalization: ||Y_l||^2 = 2l+1 on unit vectors
    ix = 0
    for l in range(lmax + 1):
        blk = got[:, ix:ix + 2 * l + 1]
        live = np.delete(blk, 3, axis=0)
        np.testing.assert_allclose((live**2).sum(-1), 2 * l + 1, rtol=1e-5)
        if l:
            assert not blk[3].any()      # zero vector: zero SH for l >= 1
        ix += 2 * l + 1


def test_spherical_harmonics_gradient_matches_jax_and_is_finite_at_zero():
    v = _vectors(seed=1)
    c = np.random.default_rng(2).normal(size=(40, 16)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        jsph.spherical_harmonics(x, 3) * c))(jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_(True)
    (tsph.spherical_harmonics(x, 3) * torch.from_numpy(c)).sum().backward()
    assert torch.isfinite(x.grad).all()
    assert not x.grad[3].any()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5, rtol=1e-5)


def test_safe_normalize_matches_jax():
    v = _vectors(seed=3)
    want = np.asarray(jnorms.safe_normalize(jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_(True)
    got = tnorms.safe_normalize(x)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-7)
    got.sum().backward()
    assert torch.isfinite(x.grad).all() and not x.grad[3].any()


def test_spherical_harmonics_rotate_with_wigner_d():
    v = _vectors(seed=4)
    R = ortho_group.rvs(3, random_state=5)
    det = float(np.sign(np.linalg.det(R)))
    Y = tsph.spherical_harmonics(torch.from_numpy(v).double(), 3).numpy()
    YR = tsph.spherical_harmonics(torch.from_numpy(v @ R.T).double(), 3).numpy()
    D = tir.irreps_rep(tir.Irreps.spherical_harmonics(3), R, det)
    np.testing.assert_allclose(YR, Y @ D.T, atol=1e-10)
