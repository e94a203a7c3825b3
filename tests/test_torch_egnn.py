"""The port's EGNNModel against the JAX package's, with the JAX model's
weights carried over by ``weights.egnn_from_jax``: outputs and every
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

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models.egnn import EGNNModel as JaxEGNN
from geometric_message_passing_tpu.ops import pallas_sorted_segsum as jss
from geometric_message_passing_tpu.ops.norms import safe_norm as jax_safe_norm
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.models import EGNNModel
from geometric_message_passing_tpu_torch.nn.basic import MLP
from geometric_message_passing_tpu_torch.ops.norms import safe_norm
from geometric_message_passing_tpu_torch.ops.sorted_segsum import batch_seg_plans
from geometric_message_passing_tpu_torch.weights import egnn_from_jax

OUT_TOL = 2e-5                  # rtol = atol on the outputs
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def batches(kind):
    """(JAX batch, the port's batch) of the same graphs."""
    if kind == "box":
        graphs = [jgraph.sort_edges_by_receiver(g) for g in
                  jds.create_molecular_boxes(n_nodes=400, seed=0)]
        batch_size = 1
    else:
        graphs = [jgraph.sort_edges_by_receiver(g) for g in
                  jds.create_star_graphs(num=6, fold=[3, 5], dim=3,
                                         target="max", seed=0)]
        batch_size = 6
    jb = next(iter(jgraph.GraphLoader(graphs, batch_size=batch_size)))
    tb = next(iter(tgraph.GraphLoader(
        [tgraph.Graph(g.atoms, g.edge_index, g.pos, g.y) for g in graphs],
        batch_size=batch_size)))
    return jb, tb


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
            egnn_from_jax({"params": jax.tree.map(np.asarray, grads)}))


def port_out_and_grads(tmodel, tb, plans=None):
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(tb, seg_plans=plans)
    (out ** 2).sum().backward()
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in tmodel.named_parameters()}
    return out.detach().numpy(), grads


def bridged(kw, jb, seed=0):
    jmodel = JaxEGNN(**kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), jb)
    tmodel = EGNNModel(**kw, device="cpu")
    tmodel.load_state_dict(egnn_from_jax(jax.tree.map(np.asarray, variables)),
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
    # the box's readout is the mean over its 400 atoms: a sum would put the
    # gradients near 1e3, where f32 sums in another order differ by more
    # than the absolute tolerance
    kw = dict(num_layers=2, emb_dim=32, in_dim=8 if kind == "box" else 1,
              out_dim=1, pool="mean" if kind == "box" else "sum")
    jb, tb = batches(kind)
    jmodel, variables, tmodel = bridged(kw, jb)
    want = jax_out_and_grads(jmodel, variables, jb)
    got = port_out_and_grads(tmodel, tb, batch_seg_plans(tb) if port_plans
                             else None)
    assert_match(got, want)


def test_seg_plans_path_matches_jax_seg_plans_path():
    kw = dict(num_layers=2, emb_dim=32, in_dim=1, out_dim=1)
    jb, tb = batches("star")
    jmodel, variables, tmodel = bridged(kw, jb)
    want = jax_out_and_grads(jmodel, variables, jb,
                             jss.batch_seg_plans(jb, interpret=True))
    assert_match(port_out_and_grads(tmodel, tb, batch_seg_plans(tb)), want)


@pytest.mark.parametrize("variant", [dict(residual=False),
                                     dict(equivariant_pred=True, pool="mean"),
                                     dict(aggr="mean"), dict(aggr="max")])
def test_options_match_jax(variant):
    kw = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=2, **variant)
    jb, tb = batches("star")
    jmodel, variables, tmodel = bridged(kw, jb, seed=1)
    assert_match(port_out_and_grads(tmodel, tb),
                 jax_out_and_grads(jmodel, variables, jb))


def test_seg_plans_need_sum_aggregation():
    _, tb = batches("star")
    model = EGNNModel(num_layers=1, emb_dim=16, aggr="max", device="cpu")
    with pytest.raises(ValueError, match="aggr"):
        model(tb, seg_plans=batch_seg_plans(tb))


def test_bridge_covers_every_parameter():
    kw = dict(num_layers=3, emb_dim=16, in_dim=4, out_dim=1)
    jb, _ = batches("star")
    _, variables, tmodel = bridged(kw, jb)
    sd = egnn_from_jax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(tmodel.state_dict())
    for key, value in tmodel.state_dict().items():
        assert sd[key].shape == value.shape, key


def test_init_is_seeded_and_torch_linear_distributed():
    def make(seed):
        return EGNNModel(2, 32, 1, 1, device="cpu",
                         generator=torch.Generator().manual_seed(seed))

    a, b, c = make(3), make(3), make(4)
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    w = a.convs[0].mlp_msg.dense[0].weight
    assert not torch.equal(w, c.convs[0].mlp_msg.dense[0].weight)
    bound = 1 / np.sqrt(2 * 32 + 1)
    assert bound >= w.abs().max() > 0.9 * bound
    assert torch.equal(a.convs[0].mlp_msg.norm[0].weight, torch.ones(32))


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EGNNModel()


def test_mlp_batch_norm_not_ported():
    # norm='batch' is ported now (tests/test_torch_batchnorm.py holds it to
    # flax); an unknown norm still raises
    mlp = MLP(4, (8, 8), norm="batch", generator=torch.Generator())
    assert [type(m).__name__ for m in mlp.norm] == ["BatchNorm", "BatchNorm"]
    assert mlp.norm[0].momentum == 0.9 and mlp.norm[0].eps == 1e-5
    with pytest.raises(ValueError):
        MLP(4, (8, 8), norm="group", generator=torch.Generator())


def test_safe_norm_matches_jax_and_is_zero_safe():
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    x[:3] = 0.0
    want = np.asarray(jax_safe_norm(jnp.asarray(x), axis=-1, keepdims=True))
    g_want = np.asarray(jax.grad(lambda v: jnp.sum(jax_safe_norm(v)))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = safe_norm(xt, keepdim=True)
    (g,) = torch.autograd.grad(got.sum(), [xt])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=1e-6)
    assert torch.all(got[:3] == 0) and torch.all(g[:3] == 0)
    assert torch.isfinite(g).all()
