"""The port's TFN (``models/tfn.py``) against the JAX package's, with the JAX
model's weights carried over by ``weights.tfn_from_jax``: output and every
parameter's gradient (2 layers, emb_dim 8, max_ell 2) with and without gate,
batch norm (training mode) and ``equivariant_pred``; invariance of the
output under rotations and reflections; ``Predictor``; and a 3-epoch
``fit_regression`` fed the JAX package's epoch permutations.  On the CPU
every K7 and K4 call takes its plain version.

Tolerances: outputs 1e-5 absolute / 1e-4 relative (f32 sums in another
order), gradients 2e-4 of max(|ref|, 1) per parameter; after 3 epochs (21
Adam steps) the per-epoch MAEs 1e-4 and the parameters 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ortho_group

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.experiments.infer import (
    Predictor as JaxPredictor)
from geometric_message_passing_tpu.models import tfn as jtfn
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.models import model_registry, tfn
from geometric_message_passing_tpu_torch.ops import edge_contract as ec
from geometric_message_passing_tpu_torch.weights import tfn_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4
KW = dict(num_layers=2, emb_dim=8, max_ell=2, mlp_dim=16, in_dim=2,
          out_dim=1)
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")


def _graphs(num=6, seed=0, in_dim=2):
    graphs = tds.create_star_graphs(num=num, fold=(4, 5, 6), seed=seed)
    rng = np.random.default_rng(seed)
    for g in graphs:
        g.atoms = rng.integers(0, in_dim, g.num_nodes).astype(np.int32)
    return graphs


def _jax_batch(tb):
    return jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})


def _bridged(kw, tb, seed=0):
    jmodel = jtfn.TFNModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), _jax_batch(tb))
    tmodel = tfn.TFNModel(**kw, device="cpu")
    tmodel.load_state_dict(tfn_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("variant", [
    dict(), dict(gate=False), dict(batch_norm=True),
    dict(equivariant_pred=True, pool="sum", aggr="mean")])
def test_model_and_gradients_match_jax(variant):
    kw = dict(KW, **variant)
    graphs = _graphs()
    tb = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 6))
    jmodel, variables, tmodel = _bridged(kw, tb)
    jb = _jax_batch(tb)
    train = bool(variant.get("batch_norm"))
    c = np.random.default_rng(1).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)

    def loss(params):
        out = jmodel.apply({**variables, "params": params}, jb, train=train,
                           mutable=["batch_stats"])[0]
        return jnp.sum(out * c), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    tmodel.train(train)
    out = tmodel(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(c)).sum().backward()
    want_grads = tfn_from_jax({"params": jax.tree.map(np.asarray, grads)})
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_output_is_invariant_under_rotations_and_reflections():
    graphs = _graphs(num=4, seed=2)
    model = tfn.TFNModel(**KW, device="cpu",
                         generator=torch.Generator().manual_seed(3)).double()
    tb = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 4))
    tb.pos = tb.pos.double()
    with torch.no_grad():
        base = model(tb)
        for seed in (0, 1):
            R = torch.from_numpy(ortho_group.rvs(3, random_state=seed))
            tb2 = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 4))
            tb2.pos = tb.pos @ R.T
            torch.testing.assert_close(model(tb2), base, atol=1e-9, rtol=1e-9)


def test_predictor_matches_jax_and_serves_in_eval_mode():
    graphs = _graphs(num=13, seed=4)
    tb = tgraph.batch_graphs(graphs[:5], *jgraph.pad_sizes(graphs, 5))
    kw = dict(KW, batch_norm=True)
    jmodel, variables, tmodel = _bridged(kw, tb)
    y = Predictor(tmodel, batch_size=5, device="cpu").predict(graphs)
    assert tmodel.training
    want = JaxPredictor(jmodel, variables, batch_size=5).predict(graphs)
    assert y.shape == (13, 1)
    np.testing.assert_allclose(y, want, atol=ATOL, rtol=RTOL)


def test_registry_defaults_and_unported_options(monkeypatch):
    assert model_registry["tfn"] is tfn.TFNModel
    model = tfn.TFNModel(device="cpu")
    jmodel = jtfn.TFNModel()
    assert (model.max_ell, len(model.convs), model.emb_dim, model.pool) == (
        jmodel.max_ell, jmodel.num_layers, jmodel.emb_dim, jmodel.pool)
    assert repr(model.hidden_irreps) == "64x0e+64x1o+64x2e"
    with pytest.raises(ValueError, match="needs mesh="):
        tfn.TFNModel(tp_axis="tp", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfn.TFNModel()


def _jax_epoch_orders(seed, m, n_epochs):
    """The permutations the JAX resident engine draws."""
    _, shuffle_key = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.permutation(
        jax.random.fold_in(shuffle_key, e), m)) for e in range(n_epochs)]


def test_fit_regression_tracks_jax_for_3_epochs():
    kw = dict(KW, in_dim=1, pool="first")
    jdata = jds.create_star_graphs(num=40, fold=(5, 6, 7), seed=0)
    tdata = tds.create_star_graphs(num=40, fold=(5, 6, 7), seed=0)
    jsplit = jgraph.random_split(jdata, [0.5, 0.2, 0.3], seed=0)
    tsplit = tgraph.random_split(tdata, [0.5, 0.2, 0.3], seed=0)
    pad = jgraph.pad_sizes(jdata, 8)
    jl = (jgraph.GraphLoader(jsplit[0], 8, shuffle=True, seed=0, pad=pad),
          jgraph.GraphLoader(jsplit[1], 8, pad=pad),
          jgraph.GraphLoader(jsplit[2], 8, pad=pad))
    tl = (tgraph.GraphLoader(tsplit[0], 8, shuffle=True, seed=0, pad=pad),
          tgraph.GraphLoader(tsplit[1], 8, pad=pad),
          tgraph.GraphLoader(tsplit[2], 8, pad=pad))
    jmodel = jtfn.TFNModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(0), next(iter(jl[0])))
    tmodel = tfn.TFNModel(**kw, device="cpu")
    tmodel.load_state_dict(tfn_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    jres = jtrain.fit_regression(jmodel, variables, *jl, n_epochs=3, lr=5e-4,
                                 seed=0)
    orders = _jax_epoch_orders(0, len(jsplit[0]), 3)
    tres = ttrain.fit_regression(
        tmodel, None, *tl, n_epochs=3, lr=5e-4, seed=0, device="cpu",
        epoch_order=lambda e: torch.from_numpy(orders[e]))
    np.testing.assert_allclose(tres.perf_per_epoch, jres.perf_per_epoch,
                               atol=1e-4, rtol=0)
    want = tfn_from_jax(jax.tree.map(np.asarray, jres.variables))
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(tres.variables[name].numpy(), w, rtol=0,
                                   atol=max(2e-4, 1e-6 * np.abs(w).max()),
                                   err_msg=name)
    assert ec.edge_weighted_contract_grouped.launches == 0
