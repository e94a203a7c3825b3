"""The port's equivariant primitives (``nn/equivariant.py``) against the JAX
package's: the block helpers, ``irreps2gate``, the second-moment constants
(1e-7 relative), ``Gate``/``Activation`` (float32, 1e-6) and
``EquivariantBatchNorm`` in both modes, masked and not, with its running
statistics (1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import irreps as jir
from geometric_message_passing_tpu.nn import equivariant as jeq
from geometric_message_passing_tpu_torch import irreps as tir
from geometric_message_passing_tpu_torch.nn import equivariant as teq

HIDDEN = "4x0e+4x1o+4x2e+4x3o"


def _x(n, dim, seed=0):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


def test_blocks_round_trip_and_padding():
    irreps = tir.Irreps(HIDDEN)
    x = _x(5, irreps.dim)
    blocks = teq.split_blocks(torch.from_numpy(x), irreps)
    want = jeq.split_blocks(jnp.asarray(x), jir.Irreps(HIDDEN))
    for b, w in zip(blocks, want):
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))
    np.testing.assert_array_equal(teq.merge_blocks(blocks).numpy(), x)
    padded = teq.pad_to_irreps(torch.from_numpy(x[:, :4]), irreps.dim)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jeq.pad_to_irreps(jnp.asarray(x[:, :4]),
                                                     irreps.dim)))


@pytest.mark.parametrize("spec", [HIDDEN, "3x0e", "2x1o+1x0e+2x1o"])
def test_irreps2gate_matches_jax(spec):
    got = teq.irreps2gate(tir.Irreps(spec))
    want = jeq.irreps2gate(jir.Irreps(spec))
    assert [repr(a) for a in got] == [repr(b) for b in want]


@pytest.mark.parametrize("name", ["silu", "sigmoid", "relu", "tanh"])
def test_second_moment_constant_matches_jax(name):
    got, want = teq._act_second_moment(name), jeq._act_second_moment(name)
    assert abs(got - want) <= 1e-7 * abs(want)


def test_gate_and_activation_match_jax():
    scalars, gates, gated = teq.irreps2gate(tir.Irreps(HIDDEN))
    gate = teq.Gate(scalars, gates, gated)
    jgate = jeq.Gate(*jeq.irreps2gate(jir.Irreps(HIDDEN)))
    x = _x(7, gate.irreps_in.dim, seed=1)
    want = np.asarray(jgate.apply({}, jnp.asarray(x)))
    got = gate(torch.from_numpy(x)).numpy()
    assert got.shape == (7, tir.Irreps(HIDDEN).dim)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    act = teq.Activation(tir.Irreps("6x0e"))
    jact = jeq.Activation(jir.Irreps("6x0e"))
    x = _x(5, 6, seed=2)
    np.testing.assert_allclose(act(torch.from_numpy(x)).numpy(),
                               np.asarray(jact.apply({}, jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError):
        teq.Activation(tir.Irreps("1x1o"))


def _bn_pair(seed=0):
    jbn = jeq.EquivariantBatchNorm(jir.Irreps(HIDDEN))
    x0 = jnp.zeros((3, jir.Irreps(HIDDEN).dim))
    variables = jbn.init(jax.random.PRNGKey(0), x0)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
        * 0.3, variables["params"])
    stats = jax.tree.map(
        lambda a: np.abs(np.asarray(a) + rng.normal(size=a.shape)
                         .astype(np.float32) * 0.3), variables["batch_stats"])
    tbn = teq.EquivariantBatchNorm(tir.Irreps(HIDDEN))
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          {**params, **stats}.items()}
    tbn.load_state_dict(sd, strict=True)
    return jbn, {"params": params, "batch_stats": stats}, tbn


@pytest.mark.parametrize("masked", [False, True])
def test_batch_norm_matches_jax_in_both_modes(masked):
    jbn, variables, tbn = _bn_pair()
    x = _x(9, tir.Irreps(HIDDEN).dim, seed=3) * 2.0 + 0.5
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    # eval: the running statistics
    want = np.asarray(jbn.apply(variables, jnp.asarray(x), train=False,
                                mask=jmask))
    got = tbn.eval()(torch.from_numpy(x), mask=tmask)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    # train: the batch's statistics, and the updated running buffers
    want, updated = jbn.apply(variables, jnp.asarray(x), train=True,
                              mask=jmask, mutable=["batch_stats"])
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tbn.train()(xt, mask=tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for key, value in updated["batch_stats"].items():
        np.testing.assert_allclose(getattr(tbn, key).numpy(),
                                   np.asarray(value), atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    # gradients in training mode against jax.grad
    c = _x(9, tir.Irreps(HIDDEN).dim, seed=4)

    def loss(p, xx):
        out, _ = jbn.apply({"params": p, "batch_stats": variables["batch_stats"]},
                           xx, train=True, mask=jmask, mutable=["batch_stats"])
        return jnp.sum(out * c)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    for key, value in gp.items():
        np.testing.assert_allclose(getattr(tbn, key).grad.numpy(),
                                   np.asarray(value), atol=1e-4, rtol=1e-4,
                                   err_msg=key)
