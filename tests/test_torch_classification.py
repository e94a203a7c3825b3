"""The port's classification path (``experiments/train.py``) against the JAX
package's: the mean cross-entropy loss and the accuracy count on padded
batches (pad graphs and sentinel slots must not count), a 10-epoch
``fit_classification`` of an MPNN on the k = 2 chains fed the JAX engine's
epoch permutations, and the ``run_experiment`` repeat protocol, which
carries each repeat's trained state into the next.

Tolerances: the loss 1e-6 relative; step losses 1e-5; accuracies equal."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.models import egnn as jegnn
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models import egnn
from geometric_message_passing_tpu_torch.weights import mpnn_from_jax

FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")
KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=2)


def _jax_batch(tb):
    return jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})


def _labelled_graphs():
    return tds.create_kchains(3) + tds.create_rotsym_envs(3, seed=1)


@pytest.mark.parametrize("layout", ["bucket", "slots"])
def test_loss_and_count_match_jax_on_padded_batches(layout):
    graphs = _labelled_graphs()
    if layout == "bucket":        # 4 real graphs, 2 pad graphs
        tb = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 5),
                                 y_dtype=np.int32)
        real = 4
    else:                         # slots 2, 0, 3 and two sentinel slots
        slot = tgraph.build_slot_data(graphs, y_dtype=np.int32)
        tb = tgraph.assemble_batch(slot, torch.tensor([2, 0, 3, 4, 4]))
        real = 3
    assert tb.y.dtype == torch.int32
    g = tb.num_graphs
    logits = np.random.default_rng(0).normal(size=(g, 3)).astype(np.float32)
    logits[real:, 0] += 10.0      # pad labels are 0: right if they counted
    jb = _jax_batch(tb)
    pred = torch.from_numpy(logits)
    loss = ttrain.cross_entropy_mean_loss(pred, tb)
    want = jtrain.cross_entropy_mean_loss(jnp.asarray(logits), jb)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    correct, total = ttrain.accuracy_count(pred, tb)
    jc, jn = jtrain.accuracy_count(jnp.asarray(logits), jb)
    assert (int(correct), int(total)) == (int(jc), int(jn))
    assert int(total) == real
    labels = tb.y.reshape(-1).long()[:real]
    assert int(correct) == int((pred[:real].argmax(-1) == labels).sum())


def _jax_epoch_orders(seed, m, n_epochs):
    """The permutations the JAX resident engine draws."""
    _, shuffle_key = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.permutation(
        jax.random.fold_in(shuffle_key, e), m)) for e in range(n_epochs)]


def _jax_step_losses(jmodel, variables, graphs, orders, lr):
    """The JAX engine's train steps written out: per epoch one batch of the
    permuted graphs, ``value_and_grad`` of its loss and an optax Adam
    update (the rate stays at ``lr``: no plateau decay within 10 epochs)."""
    slot = jgraph.build_slot_data(graphs, y_dtype=np.int32)
    tx = optax.adam(lr)
    params = variables["params"]
    opt_state = tx.init(params)
    losses = []
    for order in orders:
        batch = jgraph.assemble_batch(slot, jnp.asarray(order, jnp.int32))

        def loss_of(p):
            return jtrain.cross_entropy_mean_loss(
                jmodel.apply({"params": p}, batch), batch)

        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return np.asarray(losses, np.float32)


def test_fit_classification_tracks_jax_for_10_epochs():
    jdata, tdata = jds.create_kchains(2), tds.create_kchains(2)
    jl = jgraph.GraphLoader(jdata, batch_size=2, y_dtype=np.int32)
    tl = tgraph.GraphLoader(tdata, batch_size=2, y_dtype=np.int32)
    jmodel = jegnn.MPNNModel(**KW)
    variables = jmodel.init(jax.random.PRNGKey(1), next(iter(jl)))
    tmodel = egnn.MPNNModel(**KW, device="cpu")
    tmodel.load_state_dict(mpnn_from_jax(jax.tree.map(np.asarray, variables)))
    lr, epochs, seed = 1e-3, 10, 2
    jres = jtrain.fit_classification(jmodel, variables, jl, jl, jl,
                                     n_epochs=epochs, lr=lr, seed=seed)
    orders = _jax_epoch_orders(seed, 2, epochs)
    tres = ttrain.fit_classification(
        tmodel, None, tl, tl, tl, n_epochs=epochs, lr=lr, seed=seed,
        device="cpu", epoch_order=lambda e: torch.from_numpy(orders[e]))
    np.testing.assert_array_equal(tres.perf_per_epoch, jres.perf_per_epoch)
    assert (tres.best_val, tres.test) == (jres.best_val, jres.test)
    assert tres.train_losses.shape == (epochs, 1)
    np.testing.assert_allclose(
        tres.train_losses[:, 0],
        _jax_step_losses(jmodel, variables, jdata, orders, lr),
        atol=1e-5, rtol=0)


def test_run_experiment_carries_the_trained_state_across_repeats(monkeypatch):
    jdata, tdata = jds.create_kchains(2), tds.create_kchains(2)
    jl = jgraph.GraphLoader(jdata, batch_size=2, y_dtype=np.int32)
    tl = tgraph.GraphLoader(tdata, batch_size=2, y_dtype=np.int32)
    jmodel = jegnn.MPNNModel(**KW)
    # the JAX protocol's initial weights (run_experiment: seed 0)
    variables = jtrain.init_variables(jmodel, jtrain.seed_everything(0),
                                      jtrain.tiny_init_batch(jl))
    tmodel = egnn.MPNNModel(**KW, device="cpu")
    tmodel.load_state_dict(mpnn_from_jax(jax.tree.map(np.asarray, variables)))
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    jbest, jtest, _ = jtrain.run_experiment(jmodel, jl, jl, jl, n_epochs=5,
                                            n_times=2)

    calls = []
    fit = ttrain.fit_classification

    def recording_fit(model, variables, *args, **kw):
        res = fit(model, variables, *args, **kw)
        calls.append((variables, kw["seed"], res))
        return res

    monkeypatch.setattr(ttrain, "fit_classification", recording_fit)
    best, test, times = ttrain.run_experiment(tmodel, tl, tl, tl, n_epochs=5,
                                              n_times=2, device="cpu")
    assert (best, test) == (jbest, jtest)
    assert len(times) == 2
    assert [seed for _, seed, _ in calls] == [0, 1]
    assert calls[0][0] is None                 # repeat 0: the model's own
    assert calls[1][0] is calls[0][2].variables   # repeat 1: repeat 0's
    moved = calls[0][2].variables["convs.0.mlp_msg.dense.0.weight"]
    assert not torch.equal(moved, start["convs.0.mlp_msg.dense.0.weight"])
    for key, value in tmodel.state_dict().items():   # the input is untouched
        assert torch.equal(value, start[key]), key


def test_unknown_task_raises():
    tl = tgraph.GraphLoader(tds.create_kchains(2), batch_size=2,
                            y_dtype=np.int32)
    model = egnn.MPNNModel(**KW, device="cpu")
    with pytest.raises(ValueError, match="task"):
        ttrain.fit_resident(model, tl, tl, tl, n_epochs=1, task="ranking",
                            device="cpu")
