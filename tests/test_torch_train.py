"""The port's trainer against the JAX package's: the plateau scheduler, the
L1-sum loss, one train step (gradients and Adam update) and a 3-epoch
``fit_regression`` fed the JAX package's epoch permutations, with the same
initial weights carried across.  Plus the port's own contract:
``fit_regression`` leaves its input model untouched, so two calls agree.

Tolerances: one step's gradients 1e-5 absolute (or 1e-6 of the largest
entry), its updated parameters 1e-6; after 3 epochs (21 Adam steps, whose
normalised updates amplify f32 rounding of small gradients) the per-epoch
MAEs 1e-4 and the parameters 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.models.egnn_fused import (
    EGNNFusedModel as JaxEGNNFusedModel)
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models.egnn_fused import EGNNFusedModel
from geometric_message_passing_tpu_torch.weights import egnn_fused_from_jax

KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1, pool="first")
LR = 5e-4


def _metric_sequence():
    rng = np.random.default_rng(0)
    falling = 1.0 / np.arange(1, 41) + rng.normal(0, 0.01, 40)
    return np.concatenate([falling, np.full(20, 0.3),
                           0.3 + np.arange(20) * 0.01]).astype(np.float32)


@pytest.mark.parametrize("cfg", [
    dict(mode="max", factor=0.9, patience=15, min_lr=1e-4),
    dict(mode="min", factor=0.5, patience=3, min_lr=1e-5),
])
def test_plateau_matches_jax(cfg):
    jcfg, tcfg = jtrain.PlateauConfig(**cfg), ttrain.PlateauConfig(**cfg)
    js, ts = jtrain.plateau_init(5e-4), ttrain.plateau_init(5e-4)
    decays = 0
    for metric in _metric_sequence():
        js = jtrain.plateau_update(js, jnp.float32(metric), jcfg)
        ts = ttrain.plateau_update(ts, metric, tcfg)
        for key in ("lr", "best", "bad"):
            assert np.asarray(js[key]) == ts[key], key
        decays += int(ts["bad"] == 0)
    assert decays > 0


def _graph_sets(num, seed=0):
    jdata = jds.create_star_graphs(num=num, fold=(5, 6, 7), seed=seed)
    tdata = tds.create_star_graphs(num=num, fold=(5, 6, 7), seed=seed)
    return jdata, tdata


def _bridged(jbatch, seed=0):
    jmodel = JaxEGNNFusedModel(**KW)
    variables = jmodel.init(jax.random.PRNGKey(seed), jbatch)
    tmodel = EGNNFusedModel(**KW, device="cpu")
    tmodel.load_state_dict(
        egnn_fused_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, tmodel


def _assert_state(got, want_variables, atol):
    want = egnn_fused_from_jax(jax.tree.map(np.asarray, want_variables))
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, atol=max(atol, 1e-6 * np.abs(w).max()),
            rtol=0, err_msg=name)


@pytest.mark.parametrize("mask_cols", [None, 1])
def test_l1_sum_loss_matches_jax(mask_cols):
    jdata, tdata = _graph_sets(9)
    pad = jgraph.pad_sizes(jdata, 9)
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(pad[2], 2)).astype(np.float32)
    for g in jdata + tdata:
        g.y = np.array([g.y[0], -g.y[0]], np.float32)
    jb = jgraph.batch_graphs(jdata[:7], *pad)
    tb = tgraph.batch_graphs(tdata[:7], *pad)
    want = float(jtrain.l1_sum_loss(jnp.asarray(pred), jb, mask_cols))
    got = ttrain.l1_sum_loss(torch.from_numpy(pred), tb, mask_cols).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_train_step_matches_jax():
    jdata, tdata = _graph_sets(12)
    jslot, tslot = jgraph.build_slot_data(jdata), tgraph.build_slot_data(tdata)
    row = [4, 11, 0, 12, 12]               # two sentinel slots
    jbatch = jgraph.assemble_batch(jslot, jnp.asarray(row, jnp.int32))
    jmodel, variables, tmodel = _bridged(jbatch)

    def loss_of(params):
        pred = jmodel.apply({"params": params}, jbatch)
        return jtrain.l1_sum_loss(pred, jbatch)

    params = variables["params"]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    tx = optax.adam(LR)
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    opt = ttrain.make_tx(tmodel.parameters(), LR)
    loss = ttrain.train_step(tmodel, opt, tslot, torch.tensor(row))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_state({n: p.grad for n, p in tmodel.named_parameters()},
                  {"params": jgrads}, atol=1e-5)
    _assert_state(tmodel.state_dict(), {"params": jnew}, atol=1e-6)


def _loaders(graphs_split, pkg, pad, batch):
    tr, va, te = graphs_split
    return (pkg.GraphLoader(tr, batch, shuffle=True, seed=0, pad=pad),
            pkg.GraphLoader(va, batch, pad=pad),
            pkg.GraphLoader(te, batch, pad=pad))


def _jax_epoch_orders(seed, m, n_epochs):
    """The permutations the JAX resident engine draws (train.py:415-420)."""
    _, shuffle_key = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.permutation(
        jax.random.fold_in(shuffle_key, e), m)) for e in range(n_epochs)]


def test_fit_regression_tracks_jax_for_3_epochs(cosine=False):
    """The plateau scheduler (``cosine``: the cosine schedule, ported with
    the triplet models, whose JAX star numbers were taken with it)."""
    jdata, tdata = _graph_sets(40)
    jsplit = jgraph.random_split(jdata, [0.5, 0.2, 0.3], seed=0)
    tsplit = tgraph.random_split(tdata, [0.5, 0.2, 0.3], seed=0)
    pad = jgraph.pad_sizes(jdata, 8)
    jl = _loaders(jsplit, jgraph, pad, 8)
    tl = _loaders(tsplit, tgraph, pad, 8)
    jmodel, variables, tmodel = _bridged(next(iter(jl[0])))
    jres = jtrain.fit_regression(jmodel, variables, *jl, n_epochs=3, lr=LR,
                                 seed=0, cosine=cosine)
    orders = _jax_epoch_orders(0, len(jsplit[0]), 3)
    tres = ttrain.fit_regression(
        tmodel, tmodel.state_dict(), *tl, n_epochs=3, lr=LR, seed=0,
        device="cpu", cosine=cosine,
        epoch_order=lambda e: torch.from_numpy(orders[e]))
    assert tres.perf_per_epoch.shape == (3, 2)
    assert tres.train_losses.shape == (3, len(tl[0]))
    np.testing.assert_allclose(tres.perf_per_epoch, jres.perf_per_epoch,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose([tres.best_val, tres.test],
                               [jres.best_val, jres.test], atol=1e-4, rtol=0)
    _assert_state(tres.variables, jres.variables, atol=1e-4)


def test_fit_regression_with_cosine_tracks_jax_for_3_epochs():
    test_fit_regression_tracks_jax_for_3_epochs(cosine=True)


def test_fit_regression_does_not_train_its_input():
    _, tdata = _graph_sets(24, seed=3)
    split = tgraph.random_split(tdata, [0.5, 0.2, 0.3], seed=0)
    loaders = _loaders(split, tgraph, tgraph.pad_sizes(tdata, 6), 6)
    model = EGNNFusedModel(**KW, device="cpu",
                           generator=ttrain.seed_everything(2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    runs = [ttrain.fit_regression(model, model.state_dict(), *loaders,
                                  n_epochs=2, lr=LR, seed=1, device="cpu")
            for _ in range(2)]
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert np.array_equal(runs[0].perf_per_epoch, runs[1].perf_per_epoch)
    assert np.array_equal(runs[0].train_losses, runs[1].train_losses)
    for key, value in runs[0].variables.items():
        assert torch.equal(value, runs[1].variables[key]), key
    assert not torch.equal(runs[0].variables["convs.0.msg_w1"],
                           before["convs.0.msg_w1"])


def test_run_experiment_reg_reinstantiates_each_repeat():
    _, tdata = _graph_sets(16, seed=4)
    split = tgraph.random_split(tdata, [0.5, 0.2, 0.3], seed=0)
    loaders = _loaders(split, tgraph, tgraph.pad_sizes(tdata, 4), 4)
    best, tests, times, mean, std = ttrain.run_experiment_reg(
        EGNNFusedModel, KW, *loaders, n_epochs=1, n_times=2, lr=LR,
        device="cpu")
    assert len(best) == len(tests) == len(times) == 2
    assert best[0] != best[1]          # repeat idx seeds its own weights
    again = ttrain.fit_regression(
        EGNNFusedModel(**KW, device="cpu", generator=ttrain.seed_everything(1)),
        None, *loaders, n_epochs=1, lr=LR, seed=1, device="cpu")
    assert (again.best_val, again.test) == (best[1], tests[1])
    assert mean == pytest.approx(np.mean(tests))


def test_unported_options_raise(monkeypatch):
    _, tdata = _graph_sets(8, seed=5)
    loaders = _loaders(tgraph.random_split(tdata, [0.5, 0.25, 0.25]), tgraph,
                       tgraph.pad_sizes(tdata, 4), 4)
    model = EGNNFusedModel(**KW, device="cpu")
    # loss_mask, checkpointing and NaN recovery are ported
    # (tests/test_torch_train_options.py, tests/test_torch_checkpoint.py);
    # NaN recovery without checkpoints is refused, as the JAX package does
    for kw in (dict(nan_recovery=True),
               dict(nan_recovery=True, checkpoint_every=1),
               dict(nan_recovery=True, checkpoint_dir="never-written")):
        with pytest.raises(ValueError, match="requires checkpointing"):
            ttrain.fit_regression(model, None, *loaders, n_epochs=1,
                                  device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        ttrain.run_experiment_reg(EGNNFusedModel, KW, *loaders, n_epochs=1,
                                  n_times=1, device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.fit_regression(model, None, *loaders, n_epochs=1)


def test_cosine_lr_matches_jax():
    for epoch in (0, 1, 57, 199):
        assert ttrain.cosine_lr(5e-4, 1e-6, 200, epoch) == pytest.approx(
            float(jtrain.cosine_lr(5e-4, 1e-6, 200, epoch)), rel=1e-6)
