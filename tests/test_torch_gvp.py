"""The port's GVP primitives (``nn/gvp.py``) and radial basis against the JAX
package's, with numpy inputs and the flax parameters carried over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.nn import gvp as jgvp
from geometric_message_passing_tpu.ops import radial as jradial
from geometric_message_passing_tpu_torch.nn import gvp
from geometric_message_passing_tpu_torch.ops import radial
from geometric_message_passing_tpu_torch.weights import _gvp

ATOL = 2e-5   # f32 through one or a few products, summation order differs


@pytest.mark.parametrize("r_max,n,p", [(10.0, 8, 5), (5.0, 6, 6)])
def test_radial_embedding_matches_jax(r_max, n, p):
    r = np.concatenate([[0.0, 1e-13, 1e-6], np.linspace(0.05, 12.0, 61)])
    r = r.astype(np.float32)[:, None]
    for port, ref in (
            (radial.bessel_basis(torch.from_numpy(r), r_max, n),
             jradial.bessel_basis(jnp.asarray(r), r_max, n)),
            (radial.polynomial_cutoff(torch.from_numpy(r), r_max, p),
             jradial.polynomial_cutoff(jnp.asarray(r), r_max, p)),
            (radial.radial_embedding(torch.from_numpy(r), r_max, n, p),
             jradial.radial_embedding(jnp.asarray(r), r_max, n, p))):
        assert torch.isfinite(port).all()
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=1e-5)
    # zero past r_max, and a finite gradient at r = 0 (the pad edges)
    t = torch.from_numpy(r).requires_grad_()
    out = radial.radial_embedding(t, r_max, n, p)
    assert torch.all(out[r[:, 0] >= r_max] == 0)
    (grad,) = torch.autograd.grad(out.sum(), [t])
    assert torch.isfinite(grad).all()


def test_tuple_helpers_match_jax():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(5, 3)).astype(np.float32)
    v = rng.normal(size=(5, 2, 3)).astype(np.float32)
    merged = gvp.merge(torch.from_numpy(s), torch.from_numpy(v))
    np.testing.assert_array_equal(merged.numpy(),
                                  np.asarray(jgvp.merge(s, v)))
    s2, v2 = gvp.split(merged, 2)
    np.testing.assert_array_equal(s2.numpy(), s)
    np.testing.assert_array_equal(v2.numpy(), v)
    ts, tv = torch.from_numpy(s), torch.from_numpy(v)
    cs, cv = gvp.tuple_cat((ts, tv), (ts[:, :1], tv[:, :1]))
    js, jv = jgvp.tuple_cat((s, v), (s[:, :1], v[:, :1]))
    np.testing.assert_array_equal(cs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(jv))
    a, b = gvp.tuple_sum((ts, tv), (ts, tv))
    assert torch.equal(a, 2 * ts) and torch.equal(b, 2 * tv)
    i, j = gvp.tuple_index((ts, tv), torch.tensor([4, 0]))
    assert torch.equal(i, ts[[4, 0]]) and torch.equal(j, tv[[4, 0]])
    x = np.zeros((3, 4), np.float32)
    x[1] = 2.0
    np.testing.assert_allclose(gvp.norm_no_nan(torch.from_numpy(x)).numpy(),
                               np.asarray(jgvp.norm_no_nan(x)))


def _bridged_gvp(in_dims, out_dims, **kw):
    """(JAX GVP, its variables, the port's GVP with the same weights, input)."""
    rng = np.random.default_rng(sum(in_dims) + 7 * sum(out_dims))
    s = rng.normal(size=(6, in_dims[0])).astype(np.float32)
    v = rng.normal(size=(6, in_dims[1], 3)).astype(np.float32)
    x = (s, v) if in_dims[1] else s
    jmod = jgvp.GVP(in_dims, out_dims, **kw)
    variables = jmod.init(jax.random.PRNGKey(1), x)
    tmod = gvp.GVP(in_dims, out_dims, **kw,
                   generator=torch.Generator().manual_seed(0))
    sd = {}
    _gvp(sd, "m", jax.tree.map(np.asarray, variables)["params"])
    tmod.load_state_dict({k[2:]: v_ for k, v_ in sd.items()}, strict=True)
    return jmod, variables, tmod, x


@pytest.mark.parametrize("in_dims,out_dims,kw", [
    ((16, 4), (16, 4), {}),                                  # the default
    ((16, 4), (16, 4), dict(act_s=None, act_v=None)),        # linear last
    ((16, 0), (8, 4), dict(act_s=None, act_v=None)),         # vi = 0: V' = 0
    ((9, 1), (32, 1), dict(act_s=None, act_v=None)),         # W_e's shape
    ((12, 3), (10, 5), dict(vector_gate=False)),             # no gate
    ((12, 3), (10, 5), dict(act_s="swish", act_v="tanh")),   # other acts
    ((12, 3), (10, 0), {}),                                  # no vector out
])
def test_gvp_matches_jax(in_dims, out_dims, kw):
    jmod, variables, tmod, x = _bridged_gvp(in_dims, out_dims, **kw)
    want = jmod.apply(variables, x)
    tx = (tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple)
          else torch.from_numpy(x))
    got = tmod(tx)
    if out_dims[1]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=ATOL)
        if not in_dims[1]:
            assert torch.equal(got[1], torch.zeros(6, out_dims[1], 3))
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


def test_gvp_chain_of_three_matches_jax():
    """The (16, 4) -> (16, 4) chain as GVPConv's message runs it, with its
    gradients with respect to the input."""
    mods = [_bridged_gvp((16, 4), (16, 4), act_s=None if k == 2 else "relu",
                         act_v=None if k == 2 else "sigmoid")
            for k in range(3)]
    x = mods[0][3]

    def jax_chain(s, v):
        h = (s, v)
        for jmod, variables, _, _ in mods:
            h = jmod.apply(variables, h)
        return jnp.sum(h[0] ** 2) + jnp.sum(h[1] * 0.5)

    ts, tv = (torch.from_numpy(a).requires_grad_() for a in x)
    h = (ts, tv)
    for _, _, tmod, _ in mods:
        h = tmod(h)
    loss = (h[0] ** 2).sum() + (h[1] * 0.5).sum()
    np.testing.assert_allclose(loss.item(), float(jax_chain(*x)), rtol=1e-5)
    grads = torch.autograd.grad(loss, [ts, tv])
    want = jax.grad(jax_chain, argnums=(0, 1))(*x)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("zero_vectors", [False, True])
def test_gvp_layer_norm_matches_jax(zero_vectors):
    rng = np.random.default_rng(3)
    s = rng.normal(size=(7, 8)).astype(np.float32) * 3 + 1
    v = rng.normal(size=(7, 4, 3)).astype(np.float32)
    if zero_vectors:
        v[:] = 0.0          # W_v's output: the norm divides 0 by sqrt(1e-8)
    jmod = jgvp.GVPLayerNorm((8, 4))
    variables = jmod.init(jax.random.PRNGKey(0), (s, v))
    tmod = gvp.GVPLayerNorm((8, 4))
    got = tmod((torch.from_numpy(s), torch.from_numpy(v)))
    want = jmod.apply(variables, (s, v))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)
    if zero_vectors:
        assert torch.equal(got[1], torch.zeros_like(got[1]))
    scalar_only = gvp.GVPLayerNorm((8, 0))(torch.from_numpy(s))
    np.testing.assert_allclose(scalar_only.detach().numpy(), np.asarray(want[0]),
                               atol=ATOL)


def test_gvp_dropout_structure():
    """Torch cannot draw JAX's bits, so the dropout is held to its structure:
    seeded masks, whole vector channels kept or dropped together, the kept
    rate, the 1/(1 - rate) scale, and the identity outside training."""
    rate = 0.25
    drop = gvp.GVPDropout(rate)
    s = torch.ones(400, 50)
    v = torch.ones(400, 20, 3)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    a_s, a_v = drop((s, v), train=True, generator=gen(5))
    b_s, b_v = drop((s, v), train=True, generator=gen(5))
    c_s, _ = drop((s, v), train=True, generator=gen(6))
    assert torch.equal(a_s, b_s) and torch.equal(a_v, b_v)
    assert not torch.equal(a_s, c_s)
    scale = float(np.float32(1.0) / np.float32(1.0 - rate))
    assert set(a_s.unique().tolist()) == {0.0, scale}
    assert set(a_v.unique().tolist()) == {0.0, scale}
    # a vector channel's three components are kept or dropped together
    assert torch.equal(a_v.amin(dim=-1), a_v.amax(dim=-1))
    for kept in ((a_s > 0).float().mean(), (a_v[..., 0] > 0).float().mean()):
        assert abs(kept.item() - (1 - rate)) < 0.01
    # identity in eval mode and at rate 0; training needs a generator
    for out in (drop((s, v), train=False), gvp.GVPDropout(0.0)((s, v), True)):
        assert out[0] is s and out[1] is v
    with pytest.raises(ValueError):
        drop((s, v), train=True)
