"""The port's staged and stepwise engines against the JAX package's:
``GraphLoader.stage_epochs`` / ``stacked_epochs`` and ``_stage_epochs``
bitwise JAX's for the same seed, ``fit`` (the whole run over epochs staged
by the C++ batcher) and ``fit_stepwise`` / ``fit_regression(engine=
"stepwise")`` on a 2-layer EGNN for 3 epochs from the same weights.

Tolerances as ``test_torch_train.py``'s 3-epoch runs (21 Adam steps, whose
normalised updates amplify f32 rounding of small gradients): the per-epoch
MAEs 1e-4 and the parameters 1e-4 absolute (or 1e-6 of the largest
entry)."""

import jax
import numpy as np
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
from geometric_message_passing_tpu_torch.triplets import triplet_pad_sizes
from geometric_message_passing_tpu_torch.weights import egnn_fused_from_jax

KW = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1, pool="first")
LR = 5e-4
PLATEAU = dict(mode="max", factor=0.9, patience=15, min_lr=1e-4)


def _assert_batches_equal(got, want):
    """A port ``GraphBatch`` (torch) equal to a JAX one, field by field."""
    for name in ("atoms", "pos", "senders", "receivers", "graph_id", "y",
                 "node_mask", "edge_mask", "graph_mask", "first_node"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("shuffle", [True, False])
def test_stage_epochs_bitwise_jax(shuffle):
    jd = jds.create_star_graphs(num=10, fold=[4], seed=0)
    td = tds.create_star_graphs(num=10, fold=[4], seed=0)
    jl = jgraph.GraphLoader(jd, batch_size=4, shuffle=shuffle, seed=3)
    tl = tgraph.GraphLoader(td, batch_size=4, shuffle=shuffle, seed=3)
    got = tl.stage_epochs(3)
    assert got.atoms.shape[:2] == (3, 3)        # 3 epochs x 3 steps
    assert got.node_mask.dtype == torch.bool
    _assert_batches_equal(got, jl.stage_epochs(3))
    # the generator moved on as JAX's did: the next pass is also equal
    _assert_batches_equal(next(iter(tl)), next(iter(jl)))


def test_stacked_epochs_and_stage_fallback_match_jax():
    """With triplets ``stage_epochs`` is None (the API, as in JAX) and
    ``_stage_epochs`` stacks the loader's own batches, JAX's too."""
    jd = jds.create_star_graphs(num=7, fold=[3], seed=1)
    td = tds.create_star_graphs(num=7, fold=[3], seed=1)
    tri_pad = triplet_pad_sizes(td, 3)
    jl = jgraph.GraphLoader(jd, batch_size=3, shuffle=True, seed=0,
                            with_triplets=True, triplet_pad=tri_pad)
    tl = tgraph.GraphLoader(td, batch_size=3, shuffle=True, seed=0,
                            with_triplets=True, triplet_pad=tri_pad)
    assert tl.stage_epochs(2) is None and jl.stage_epochs(2) is None
    got, want = ttrain._stage_epochs(tl, 2), jtrain._stage_epochs(jl, 2)
    _assert_batches_equal(got, want)
    for name in ("idx_i", "idx_kj", "idx_ji", "t_mask"):
        np.testing.assert_array_equal(getattr(got.triplets, name).numpy(),
                                      np.asarray(getattr(want.triplets, name)))
    flat = tgraph.GraphLoader(td, batch_size=3, shuffle=True, seed=0)
    listed = flat.stacked_epochs(2)
    assert len(listed) == 2 * len(flat)
    _assert_batches_equal(ttrain.stack_batches(listed[:3]),
                          jtrain.stack_batches(
                              jgraph.GraphLoader(jd, batch_size=3,
                                                 shuffle=True, seed=0)
                              .stacked_epochs(1)))


def _setup(n=40):
    jdata = jds.create_star_graphs(num=n, fold=(5, 6, 7), seed=0)
    tdata = tds.create_star_graphs(num=n, fold=(5, 6, 7), seed=0)
    jsplit = jgraph.random_split(jdata, [0.5, 0.2, 0.3], seed=0)
    tsplit = tgraph.random_split(tdata, [0.5, 0.2, 0.3], seed=0)
    pad = jgraph.pad_sizes(jdata, 8)

    def loaders(pkg, split):
        tr, va, te = split
        return (pkg.GraphLoader(tr, 8, shuffle=True, seed=0, pad=pad),
                pkg.GraphLoader(va, 8, pad=pad), pkg.GraphLoader(te, 8, pad=pad))

    jl, tl = loaders(jgraph, jsplit), loaders(tgraph, tsplit)
    jmodel = JaxEGNNFusedModel(**KW)
    variables = jmodel.init(jax.random.PRNGKey(0), next(iter(jl[1])))
    tmodel = EGNNFusedModel(**KW, device="cpu")
    tmodel.load_state_dict(
        egnn_fused_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    return jl, tl, jmodel, variables, tmodel


def _assert_state(got, want_variables, atol):
    want = egnn_fused_from_jax(jax.tree.map(np.asarray, want_variables))
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, atol=max(atol, 1e-6 * np.abs(w).max()),
            rtol=0, err_msg=name)


def _assert_runs_match(tres, jres, steps):
    assert tres.perf_per_epoch.shape == (3, 2)
    assert tres.train_losses.shape == (3, steps)
    np.testing.assert_allclose(tres.perf_per_epoch,
                               np.asarray(jres.perf_per_epoch), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose([tres.best_val, tres.test],
                               [jres.best_val, jres.test], atol=1e-4, rtol=0)
    _assert_state(tres.variables, jres.variables, atol=1e-4)


@pytest.mark.parametrize("cosine", [False, True])
def test_staged_fit_tracks_jax_for_3_epochs(cosine):
    jl, tl, jmodel, variables, tmodel = _setup()
    jtrain_epochs = jtrain._stage_epochs(jl[0], 3)
    jval, jtest = (jtrain.stack_batches(list(ld)) for ld in jl[1:])
    jres = jtrain.fit(jmodel, variables, jtrain_epochs, jval, jtest,
                      jl[1].num_examples, jl[2].num_examples, n_epochs=3,
                      lr=LR, cosine=cosine,
                      plateau=jtrain.PlateauConfig(**PLATEAU), seed=0)
    staged = ttrain._stage_epochs(tl[0], 3)
    _assert_batches_equal(staged, jtrain_epochs)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tres = ttrain.fit(tmodel, None, staged,
                      *(ttrain.stack_batches(list(ld)) for ld in tl[1:]),
                      tl[1].num_examples, tl[2].num_examples, n_epochs=3,
                      lr=LR, cosine=cosine,
                      plateau=ttrain.PlateauConfig(**PLATEAU), seed=0,
                      device="cpu")
    _assert_runs_match(tres, jres, len(tl[0]))
    for key, value in tmodel.state_dict().items():    # trains a copy
        assert torch.equal(value, before[key]), key


def _jax_epoch_orders(seed, m, n_epochs):
    """The permutations the JAX host-looped engines draw."""
    _, shuffle_key = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.permutation(
        jax.random.fold_in(shuffle_key, e), m)) for e in range(n_epochs)]


@pytest.mark.parametrize("plateau", [PLATEAU, None])
def test_fit_stepwise_tracks_jax_for_3_epochs(plateau):
    """``plateau`` None: JAX's stepwise engine keeps the rate constant."""
    jl, tl, jmodel, variables, tmodel = _setup()
    jp = None if plateau is None else jtrain.PlateauConfig(**plateau)
    tp = None if plateau is None else ttrain.PlateauConfig(**plateau)
    jres = jtrain.fit_stepwise(jmodel, variables, *jl, n_epochs=3, lr=LR,
                               plateau=jp, seed=0)
    orders = _jax_epoch_orders(0, jl[0].num_examples, 3)
    tres = ttrain.fit_stepwise(
        tmodel, tmodel.state_dict(), *tl, n_epochs=3, lr=LR, plateau=tp,
        seed=0, device="cpu", epoch_order=lambda e: torch.from_numpy(orders[e]))
    _assert_runs_match(tres, jres, len(tl[0]))


def test_fit_regression_stepwise_engine_is_the_resident_one():
    _, tl, _, _, tmodel = _setup(24)
    runs = [ttrain.fit_regression(tmodel, None, *tl, n_epochs=2, lr=LR,
                                  seed=1, device="cpu", engine=engine)
            for engine in (None, "stepwise")]
    assert np.array_equal(runs[0].perf_per_epoch, runs[1].perf_per_epoch)
    assert np.array_equal(runs[0].train_losses, runs[1].train_losses)
    for key, value in runs[0].variables.items():
        assert torch.equal(value, runs[1].variables[key]), key
    assert ttrain.STEPWISE_MODELS == jtrain.STEPWISE_MODELS
    assert ttrain.RESIDENT_CHUNK == jtrain.RESIDENT_CHUNK
    with pytest.raises(ValueError, match="engine"):
        ttrain.fit_regression(tmodel, None, *tl, n_epochs=1, device="cpu",
                              engine="monolith")
