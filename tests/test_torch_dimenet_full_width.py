"""The port's DimeNet++ at the full width of the accuracy sweep's
``dimenet/paired_star`` row against the JAX package's: ``DimeNetPPModel``
at its registry defaults (4 layers, hidden 128, int_emb 64, basis 8,
out_emb 256, 7 spherical x 6 radial; ``in_dim`` 4 and ``out_dim`` 2 for two
pairs, as the CLI builds it), the JAX model's weights carried over by
``weights.dimenet_from_jax`` with each output block's last Linear (zero at
init in both packages) drawn so that every gradient is exercised, on a
batch of 10 fold-7 paired stars made from a numpy seed.  The outputs and
every parameter's gradient of one L1-sum step are compared; on the CPU the
triplet fold (K3) and the other sums (K4) take their plain versions.

Tolerances: outputs 1e-5 absolute / 1e-4 relative (f32 sums in another
order); gradients 1e-4 of max(|ref|, 1) per parameter."""

import jax
import numpy as np
import pytest

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import triplets as jtri
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.models import dimenet as jdimenet
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models import dimenet
from geometric_message_passing_tpu_torch.weights import dimenet_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 1e-4
N_PAIRS = 2
KW = dict(num_layers=4, in_dim=N_PAIRS + 2, out_dim=N_PAIRS)


@pytest.fixture(scope="module")
def bridged():
    jtri._TRIPLET_CACHE.clear()      # keyed by id(graph): start it empty
    graphs = tds.create_paired_star_graphs(num=10, fold=[7], dim=3,
                                           n_pairs=N_PAIRS, seed=0)
    pad = jgraph.pad_sizes(graphs, 10)
    jb = next(iter(jgraph.GraphLoader(graphs, 10, pad=pad,
                                      with_triplets=True)))
    tb = next(iter(tgraph.GraphLoader(graphs, 10, pad=pad,
                                      with_triplets=True)))
    jmodel = jdimenet.DimeNetPPModel(**KW)
    params = jax.tree.map(np.asarray,
                          jmodel.init(jax.random.PRNGKey(0), jb)["params"])
    rng = np.random.default_rng(1)
    for name, block in params.items():
        if name.startswith("output_"):
            last = max(block, key=lambda k: int(k.rsplit("_", 1)[1]))
            shape = block[last]["kernel"].shape
            block[last]["kernel"] = rng.normal(0, 0.5, shape).astype(
                np.float32)
    tmodel = dimenet.DimeNetPPModel(**KW, device="cpu")
    tmodel.load_state_dict(dimenet_from_jax({"params": params}), strict=True)
    yield jmodel, params, jb, tmodel, tb
    jtri._TRIPLET_CACHE.clear()


def test_model_is_the_registry_default_width(bridged):
    _, params, _, tmodel, tb = bridged
    jmodel = jdimenet.DimeNetPPModel()
    assert (jmodel.num_layers, jmodel.hidden_channels, jmodel.int_emb_size,
            jmodel.out_emb_channels) == (4, 128, 64, 256)
    assert sum(p.numel() for p in tmodel.parameters()) == sum(
        np.size(leaf) for leaf in jax.tree.leaves(params))
    assert int(tb.graph_mask.sum()) == 10 and tb.y.shape[1] == N_PAIRS


def test_output_and_l1_step_gradients_match_jax(bridged):
    jmodel, params, jb, tmodel, tb = bridged

    def loss(p):
        out = jmodel.apply({"params": p}, jb)
        return jtrain.l1_sum_loss(out, jb), out

    (jloss, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tmodel(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    tloss = ttrain.l1_sum_loss(out, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=ATOL, rtol=RTOL)
    tloss.backward()
    want_grads = dimenet_from_jax({"params": jax.tree.map(np.asarray, grads)})
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))
