"""K7's plain versions (``ops/edge_contract.py``) against the JAX package's
Pallas kernel run by the Mosaic interpreter (``edge_weighted_contract(...,
force="interpret")``) and its einsum twin, at the shapes of
``tests/test_pallas.py``: forward and both gradients through the autograd
function, including bf16 W (its cotangent keeps bf16) and a ragged E.
Tolerances are the JAX test's: 2e-5 for f32 W, 3e-2 for bf16, the
gradients scaled by max(|ref|, 1).  On the CPU no kernel launches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.ops import pallas_tp
from geometric_message_passing_tpu_torch.ops import edge_contract as ec

SHAPES = [(70, 96, 16, 7, "float32"), (64, 32, 8, 1, "float32"),
          (33, 64, 16, 5, "bfloat16")]


def _inputs(E, K, w, m, wdtype, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((E, K, m)).astype(np.float32)
    W = rng.standard_normal((E, K, w)).astype(np.float32)
    jW = jnp.asarray(W, getattr(jnp, wdtype))
    tW = torch.from_numpy(W).to(getattr(torch, wdtype))
    return T, jW, tW


@pytest.mark.parametrize("E,K,w,m,wdtype", SHAPES)
def test_plain_matches_the_interpreted_pallas_kernel(E, K, w, m, wdtype):
    T, jW, tW = _inputs(E, K, w, m, wdtype)
    tol = 2e-5 if wdtype == "float32" else 3e-2
    jT = jnp.asarray(T)
    want = np.asarray(pallas_tp.edge_weighted_contract(jT, jW, te=32,
                                                       force="interpret"))
    Tt = torch.from_numpy(T).requires_grad_(True)
    Wt = tW.clone().requires_grad_(True)
    before = (ec.edge_weighted_contract.launches,
              ec.edge_weighted_contract.bwd_launches)
    out = ec.edge_weighted_contract(Tt, Wt)
    assert out.dtype == torch.float32 and out.shape == (E, w, m)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=tol)

    def loss(T_, W_):
        return jnp.sum(jnp.square(pallas_tp.edge_weighted_contract(
            T_, W_, te=32, force="interpret")))

    gT, gW = jax.grad(loss, argnums=(0, 1))(jT, jW)
    (out**2).sum().backward()
    assert Wt.grad.dtype == Wt.dtype
    for got, ref in ((Tt.grad, gT), (Wt.grad, gW)):
        ref = np.asarray(ref.astype(jnp.float32))
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol * scale)
    assert (ec.edge_weighted_contract.launches,
            ec.edge_weighted_contract.bwd_launches) == before


@pytest.mark.parametrize("E,K,w,m,wdtype", SHAPES)
def test_plain_versions_match_the_einsum_twin(E, K, w, m, wdtype):
    T, jW, tW = _inputs(E, K, w, m, wdtype, seed=1)
    np.testing.assert_allclose(
        ec.edge_weighted_contract_plain(torch.from_numpy(T), tW).numpy(),
        np.asarray(pallas_tp._contract_xla(jnp.asarray(T), jW)),
        atol=2e-5 if wdtype == "float32" else 3e-2)
    dO = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (E, w, m)).astype(np.float32))
    dT, dW = ec.edge_weighted_contract_bwd(torch.from_numpy(T), tW, dO)
    _, vjp = jax.vjp(pallas_tp._contract_xla, jnp.asarray(T), jW)
    jdT, jdW = vjp(jnp.asarray(dO.numpy()))
    assert dW.dtype == tW.dtype and dT.dtype == torch.float32
    np.testing.assert_allclose(dT.numpy(), np.asarray(jdT), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(dW.float().numpy(),
                               np.asarray(jdW.astype(jnp.float32)),
                               atol=1e-4 if wdtype == "float32" else 0.1,
                               rtol=1e-5 if wdtype == "float32" else 1e-2)


def test_float64_autograd_is_exact():
    rng = np.random.default_rng(3)
    T = torch.from_numpy(rng.standard_normal((5, 12, 3))).requires_grad_(True)
    W = torch.from_numpy(rng.standard_normal((5, 12, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(ec.edge_weighted_contract, (T, W))


def test_card_inputs_are_checked():
    T = torch.zeros((4, 6, 4))
    W = torch.zeros((4, 6, 3))
    with pytest.raises(ValueError, match="odd"):
        ec._check(T, W)
    with pytest.raises(ValueError, match="float32"):
        ec._check(T.double()[..., :3], W)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ec._check(T[..., :3], W.half())
    with pytest.raises(ValueError, match="do not match"):
        ec._check(T[..., :3], W[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        ec.edge_weighted_contract(T[..., :3].to("meta"), W.to("meta"))
