"""The port's TFN at its star configuration's full width against the JAX
package's: ``TFNModel`` at ``experiments/bench.py::TFN_STAR`` (4 layers,
max_ell 3, emb 64, mlp 256, gate, residual, pool first, the edge products
in exact f32), the JAX model's weights carried over by
``weights.tfn_from_jax``, on a batch of 10 fold-7 star graphs made from a
numpy seed.  The outputs and every parameter's gradient of one L1-sum step
are compared; on the CPU K7 and K4 take their plain versions.

Tolerances: outputs 1e-5 absolute / 1e-4 relative (f32 sums in another
order); gradients 1e-4 of max(|ref|, 1) per parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.models import tfn as jtfn
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.experiments.bench import TFN_STAR
from geometric_message_passing_tpu_torch.models import tfn
from geometric_message_passing_tpu_torch.weights import tfn_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 1e-4
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")


@pytest.fixture(scope="module")
def bridged():
    graphs = tds.create_star_graphs(num=10, fold=[7], dim=3, target="max",
                                    seed=0)
    tb = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 10))
    jb = jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})
    kw = dict(TFN_STAR, in_dim=1, out_dim=1)
    jmodel = jtfn.TFNModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(0), jb)
    tmodel = tfn.TFNModel(**kw, device="cpu")
    tmodel.load_state_dict(tfn_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    return jmodel, variables, jb, tmodel, tb


def test_star_configuration_is_full_width(bridged):
    _, _, _, tmodel, tb = bridged
    assert TFN_STAR == dict(num_layers=4, max_ell=3, emb_dim=64, mlp_dim=256,
                            pool="first", gate=True, residual=True,
                            tp_precision="highest")
    assert len(tmodel.convs) == 4
    assert repr(tmodel.hidden_irreps) == "64x0e+64x1o+64x2e+64x3o"
    assert int(tb.graph_mask.sum()) == 10 and int(tb.edge_mask.sum()) == 140


def test_output_and_l1_step_gradients_match_jax(bridged):
    jmodel, variables, jb, tmodel, tb = bridged

    def loss(params):
        out = jmodel.apply({**variables, "params": params}, jb)
        return jtrain.l1_sum_loss(out, jb), out

    (jloss, want), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    tmodel.train()
    out = tmodel(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    tloss = ttrain.l1_sum_loss(out, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=ATOL, rtol=RTOL)
    tloss.backward()
    want_grads = tfn_from_jax({"params": jax.tree.map(np.asarray, grads)})
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))
