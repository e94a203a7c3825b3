"""The port's MPNN (``models/egnn.py::MPNNModel``) against the JAX
package's, with the JAX model's weights carried over by
``weights.mpnn_from_jax``: the output and every parameter's gradient on a
padded two-graph batch, for ``aggr`` sum, mean and max and with the
residual on and off; and the output layer's equal rows.  On the CPU every
segment sum takes its plain version.

Tolerances: outputs 1e-5 absolute, gradients 1e-4 of max(|ref|, 1) per
parameter (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models import egnn as jegnn
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.models import egnn, model_registry
from geometric_message_passing_tpu_torch.nn.basic import OutputLinear, linear
from geometric_message_passing_tpu_torch.weights import mpnn_from_jax

ATOL = 1e-5
GRAD_REL = 1e-4
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")


def _batch():
    """Two star graphs (atom types 0-2 drawn from a seed) in a bucket with
    pad nodes, pad edges and a pad graph."""
    graphs = tds.create_star_graphs(num=2, fold=(4, 6), seed=1)
    rng = np.random.default_rng(1)
    for g in graphs:
        g.atoms = rng.integers(0, 3, g.num_nodes).astype(np.int32)
    return tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 3))


def _jax_batch(tb):
    return jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
@pytest.mark.parametrize("residual", [True, False])
def test_model_and_gradients_match_jax(aggr, residual):
    kw = dict(num_layers=2, emb_dim=16, in_dim=3, out_dim=2, aggr=aggr,
              residual=residual)
    tb = _batch()
    jb = _jax_batch(tb)
    jmodel = jegnn.MPNNModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(3), jb)
    tmodel = egnn.MPNNModel(**kw, device="cpu")
    tmodel.load_state_dict(mpnn_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    c = np.random.default_rng(2).normal(size=(tb.num_graphs, 2)).astype(
        np.float32)

    def loss(params):
        out = jmodel.apply({"params": params}, jb)
        return jnp.sum(out * c), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    out = tmodel(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    (out * torch.from_numpy(c)).sum().backward()
    want_grads = mpnn_from_jax({"params": jax.tree.map(np.asarray, grads)})
    assert {n for n, _ in tmodel.named_parameters()} == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name, rtol=0,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_registry_defaults_match_jax(monkeypatch):
    assert model_registry["mpnn"] is egnn.MPNNModel
    model = egnn.MPNNModel(device="cpu")
    jmodel = jegnn.MPNNModel()
    assert (len(model.convs), model.emb_dim, model.pool, model.residual,
            model.convs[0].aggr) == (jmodel.num_layers, jmodel.emb_dim,
                                     jmodel.pool, jmodel.residual, jmodel.aggr)
    assert egnn.MPNNLayer(8, generator=torch.Generator()).aggr == "add"
    with pytest.raises(ValueError, match="aggr"):
        egnn.MPNNModel(aggr="median", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egnn.MPNNModel()


@pytest.mark.parametrize("out_dim", [1, 2, 3, 8])
def test_output_layer_computes_equal_rows_alike(out_dim):
    """``nn.basic.OutputLinear``, every model's output layer: equal input
    rows give bitwise-equal outputs wherever they sit in the batch (on the
    CPU ``F.linear`` rounds the rows of a 2- or 3-column output
    differently, which decided the argmax of two isomorphic graphs'
    logits), and the values are ``torch.nn.Linear``'s."""
    gen = torch.Generator().manual_seed(out_dim)
    for trial in range(100):
        layer = linear(32, out_dim, gen, OutputLinear)
        row = torch.relu(torch.randn(1, 32, generator=gen)) * 10
        x = torch.cat([row.repeat(2, 1),
                       torch.randn(1 + trial % 5, 32, generator=gen)])
        with torch.no_grad():
            y = layer(x)
            want = torch.nn.functional.linear(x, layer.weight, layer.bias)
        assert torch.equal(y[0], y[1])
        torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
