"""The port's SchNetModel against the JAX package's, with the JAX model's
weights carried over by ``weights.schnet_from_jax``: outputs and every
parameter's gradient, on a 400-atom receiver-sorted molecular box and on the
6-star batch of ``tests/test_pallas.py``, with and without ``seg_plans``.
The JAX model runs its plain (XLA) path, and once its ``seg_plans`` path in
interpret mode; the port on the CPU runs the sorted segment sum's plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.models.schnet import (
    SchNetModel as JaxSchNet, shifted_softplus as jax_ssp)
from geometric_message_passing_tpu.ops import pallas_sorted_segsum as jss
from geometric_message_passing_tpu.ops.radial import (
    gaussian_smearing as jax_gaussian_smearing)
from geometric_message_passing_tpu_torch.models import SchNetModel
from geometric_message_passing_tpu_torch.models.schnet import shifted_softplus
from geometric_message_passing_tpu_torch.ops.radial import gaussian_smearing
from geometric_message_passing_tpu_torch.ops.sorted_segsum import batch_seg_plans
from geometric_message_passing_tpu_torch.weights import schnet_from_jax

from test_torch_egnn import GRAD_ATOL, GRAD_RTOL, OUT_TOL, batches


def jax_out_and_grads(jmodel, variables, jb, plans=None):
    @jax.jit
    def out_and_grads(params):
        def loss(p):
            out = jmodel.apply({**variables, "params": p}, jb, seg_plans=plans)
            return jnp.sum(out ** 2), out

        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return out, grads

    out, grads = out_and_grads(variables["params"])
    return (np.asarray(out),
            schnet_from_jax({"params": jax.tree.map(np.asarray, grads)}))


def port_out_and_grads(tmodel, tb, plans=None):
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(tb, seg_plans=plans)
    (out ** 2).sum().backward()
    return out.detach().numpy(), {name: p.grad for name, p in
                                  tmodel.named_parameters()}


def bridged(kw, jb, seed=0):
    jmodel = JaxSchNet(**kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), jb)
    tmodel = SchNetModel(**kw, device="cpu")
    tmodel.load_state_dict(schnet_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    return jmodel, variables, tmodel


def assert_match(got, want):
    out, grads = got
    out_w, grads_w = want
    np.testing.assert_allclose(out, out_w, rtol=OUT_TOL, atol=OUT_TOL)
    assert set(grads) == set(grads_w)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads_w[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("port_plans", [False, True])
@pytest.mark.parametrize("kind", ["box", "star"])
def test_matches_jax_plain_path(kind, port_plans):
    # the box's readout is the mean over its 400 atoms (see test_torch_egnn);
    # the model keeps its default cutoff 10.0 over the box's 3.0 radius
    kw = dict(num_layers=2, hidden_channels=32, num_filters=32,
              in_dim=8 if kind == "box" else 1, out_dim=1,
              pool="mean" if kind == "box" else "sum")
    jb, tb = batches(kind)
    jmodel, variables, tmodel = bridged(kw, jb)
    want = jax_out_and_grads(jmodel, variables, jb)
    got = port_out_and_grads(tmodel, tb, batch_seg_plans(tb) if port_plans
                             else None)
    assert_match(got, want)


def test_seg_plans_path_matches_jax_seg_plans_path():
    kw = dict(num_layers=2, hidden_channels=32, num_filters=32, in_dim=1,
              out_dim=1)
    jb, tb = batches("star")
    jmodel, variables, tmodel = bridged(kw, jb)
    want = jax_out_and_grads(jmodel, variables, jb,
                             jss.batch_seg_plans(jb, interpret=True))
    assert_match(port_out_and_grads(tmodel, tb, batch_seg_plans(tb)), want)


@pytest.mark.parametrize("kw", [dict(cutoff=1.5, num_gaussians=20, pool="first"),
                                dict(num_filters=24, out_dim=3, pool="mean")])
def test_options_match_jax(kw):
    kw = dict(dict(num_layers=2, hidden_channels=16, num_filters=16, in_dim=1,
                   out_dim=1), **kw)
    jb, tb = batches("star")
    jmodel, variables, tmodel = bridged(kw, jb, seed=1)
    assert_match(port_out_and_grads(tmodel, tb),
                 jax_out_and_grads(jmodel, variables, jb))


def test_bridge_covers_every_parameter():
    kw = dict(num_layers=3, hidden_channels=16, num_filters=8, in_dim=3)
    jb, _ = batches("star")
    _, variables, tmodel = bridged(kw, jb)
    sd = schnet_from_jax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(tmodel.state_dict())
    assert tmodel.embedding.weight.shape == (100, 16)   # whatever in_dim is
    assert tmodel.interactions[0].dense_2.bias is None
    for key, value in tmodel.state_dict().items():
        assert sd[key].shape == value.shape, key


def test_init_is_seeded_and_glorot_distributed():
    def make(seed):
        return SchNetModel(32, num_filters=32, num_layers=2, device="cpu",
                           generator=torch.Generator().manual_seed(seed))

    a, b, c = make(5), make(5), make(6)
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    w = a.interactions[0].dense_1.weight
    assert not torch.equal(w, c.interactions[0].dense_1.weight)
    bound = np.sqrt(6 / 64)
    assert bound >= w.abs().max() > 0.9 * bound
    assert torch.equal(a.interactions[0].dense_1.bias, torch.zeros(32))


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SchNetModel()


def test_gaussian_smearing_and_softplus_match_jax():
    r = np.random.default_rng(0).uniform(0, 12, 50).astype(np.float32)
    for start, stop, num in ((0.0, 10.0, 50), (0.5, 3.0, 7)):
        want = np.asarray(jax_gaussian_smearing(jnp.asarray(r), start, stop, num))
        got = gaussian_smearing(torch.from_numpy(r), start, stop, num)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    x = np.linspace(-30, 30, 101).astype(np.float32)
    np.testing.assert_allclose(shifted_softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_ssp(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
