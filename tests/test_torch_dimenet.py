"""The port's DimeNet++ (``models/dimenet.py``) against the JAX package's,
with the JAX model's weights carried over by ``weights.dimenet_from_jax``:
output and every parameter's gradient (2 layers, hidden 16, int_emb 8,
basis 4, ns 4, nr 3) unchunked and with ``triplet_chunk = T // 3 - 1`` (the
basis in the chunk or materialised); the chunked triplet fold against the
unchunked one; invariance under rotations; ``Predictor``; and a 3-epoch
``fit_regression`` fed the JAX package's epoch permutations.  The output
blocks' last Linear starts at 0 in both packages; the tests draw it at
random, so that every gradient is exercised.  On the CPU the fold (K3) and
the other sums (K4) take their plain versions.

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
from geometric_message_passing_tpu import triplets as jtri
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.experiments.infer import (
    Predictor as JaxPredictor)
from geometric_message_passing_tpu.models import dimenet as jdimenet
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.models import dimenet, model_registry
from geometric_message_passing_tpu_torch.weights import dimenet_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4
KW = dict(num_layers=2, hidden_channels=16, int_emb_size=8, basis_emb_size=4,
          out_emb_channels=16, num_spherical=4, num_radial=3,
          num_output_layers=2, out_dim=1)


@pytest.fixture(autouse=True)
def fresh_jax_triplet_cache():
    """The JAX package caches each graph's triplets under ``id(graph)``
    without keeping the graph alive, so a graph freed by an earlier test can
    hand its id, and its stale triplets, to a new one.  Start each test with
    that cache empty (the port's cache holds its graphs)."""
    jtri._TRIPLET_CACHE.clear()
    yield
    jtri._TRIPLET_CACHE.clear()


def _graphs(num=6, seed=0, fold=(4, 5, 6)):
    return tds.create_star_graphs(num=num, fold=fold, seed=seed)


def _batches(graphs, batch_size):
    pad = jgraph.pad_sizes(graphs, batch_size)
    jb = next(iter(jgraph.GraphLoader(graphs, batch_size, pad=pad,
                                      with_triplets=True)))
    tb = next(iter(tgraph.GraphLoader(graphs, batch_size, pad=pad,
                                      with_triplets=True)))
    return jb, tb


def _random_heads(variables, seed=1):
    """The variables with each output block's last (zero) Linear drawn."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    for name, block in params.items():
        if name.startswith("output_"):
            last = max(block, key=lambda k: int(k.rsplit("_", 1)[1]))
            shape = block[last]["kernel"].shape
            block[last]["kernel"] = rng.normal(0, 0.5, shape).astype(np.float32)
    return {"params": params}


def _bridged(kw, jb, seed=0):
    jmodel = jdimenet.DimeNetPPModel(**kw)
    variables = _random_heads(jmodel.init(jax.random.PRNGKey(seed), jb))
    tmodel = dimenet.DimeNetPPModel(**kw, device="cpu")
    tmodel.load_state_dict(dimenet_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def _chunk(tb):
    return tb.triplets.num_triplets // 3 - 1


@pytest.mark.parametrize("variant", [
    dict(), dict(chunked=True), dict(chunked=True, sbf_in_chunk=False),
    dict(pool="mean", num_after_skip=1)])
def test_model_and_gradients_match_jax(variant):
    graphs = _graphs()
    jb, tb = _batches(graphs, 6)
    kw = dict(KW, **{k: v for k, v in variant.items() if k != "chunked"})
    if variant.get("chunked"):
        kw["triplet_chunk"] = _chunk(tb)
    jmodel, variables, tmodel = _bridged(kw, jb)
    c = np.random.default_rng(2).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)

    def loss(params):
        out = jmodel.apply({"params": params}, jb)
        return jnp.sum(out * c), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    out = tmodel(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(c)).sum().backward()
    want_grads = dimenet_from_jax({"params": jax.tree.map(np.asarray, grads)})
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("sbf_in_chunk", [True, False])
def test_chunked_fold_matches_unchunked(sbf_in_chunk):
    """``triplet_chunk`` slices the triplet axis (the last chunk shorter,
    each chunk's idx_ji ascending): the same output and gradients."""
    graphs = _graphs(num=6, seed=3, fold=(4, 5))
    _, tb = _batches(graphs, 3)
    gen = torch.Generator().manual_seed(4)
    model = dimenet.DimeNetPPModel(**KW, generator=gen, device="cpu")
    with torch.no_grad():
        for out in model.outputs:
            out.lin.weight.normal_(0, 0.5, generator=gen)
    chunked = dimenet.DimeNetPPModel(**KW, triplet_chunk=_chunk(tb),
                                     sbf_in_chunk=sbf_in_chunk, device="cpu")
    chunked.load_state_dict(model.state_dict())
    fold = dimenet.TripletFold(tb.triplets.idx_ji, tb.triplets.t_mask,
                               tb.num_edges, _chunk(tb))
    assert len(fold.slices) == 4 and fold.slices[-1].stop == tb.triplets.num_triplets
    want, got = model(tb), chunked(tb)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=ATOL, rtol=RTOL)
    (want ** 2).sum().backward()
    (got ** 2).sum().backward()
    for (name, p), q in zip(model.named_parameters(), chunked.parameters()):
        ref = p.grad.numpy()
        np.testing.assert_allclose(q.grad.numpy(), ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_output_is_invariant_under_rotations():
    graphs = _graphs(num=4, seed=5)
    model = dimenet.DimeNetPPModel(
        **KW, device="cpu", generator=torch.Generator().manual_seed(6)).double()
    with torch.no_grad():
        for out in model.outputs:
            out.lin.weight.fill_(0.3)
    _, tb = _batches(graphs, 4)
    tb.pos = tb.pos.double()
    with torch.no_grad():
        base = model(tb)
        assert base.abs().max() > 0
        for seed in (0, 1):
            R = torch.from_numpy(ortho_group.rvs(3, random_state=seed))
            tb.pos, pos = tb.pos @ R.T, tb.pos
            torch.testing.assert_close(model(tb), base, atol=1e-9, rtol=1e-9)
            tb.pos = pos


def test_predictor_matches_jax():
    graphs = _graphs(num=13, seed=7)
    jb, _ = _batches(graphs[:5], 5)
    jmodel, variables, tmodel = _bridged(KW, jb)
    pred = Predictor(tmodel, batch_size=5, device="cpu", needs_triplets=True)
    y = pred.predict(graphs)
    want = JaxPredictor(jmodel, variables, batch_size=5,
                        needs_triplets=True).predict(graphs)
    assert y.shape == (13, 1) and np.isfinite(y).all()
    np.testing.assert_allclose(y, want, atol=ATOL, rtol=RTOL)
    assert pred.triplet_pad[0] >= 5 * 42 and pred.trace_count == 1
    # larger stars grow the node and triplet buckets once
    big = tds.create_star_graphs(num=3, fold=(9,), seed=8)
    np.testing.assert_allclose(
        pred.predict(big),
        JaxPredictor(jmodel, variables, batch_size=5,
                     needs_triplets=True).predict(big), atol=ATOL, rtol=RTOL)
    assert pred.trace_count == 2 and pred.triplet_pad[0] >= 5 * 72


def test_registry_defaults_and_device(monkeypatch):
    assert model_registry["dimenet"] is dimenet.DimeNetPPModel
    model = dimenet.DimeNetPPModel(device="cpu")
    jmodel = jdimenet.DimeNetPPModel()
    inter = model.interactions[0]
    assert (len(model.interactions), inter.lin_ji.in_features,
            inter.lin_down.out_features, inter.lin_rbf1.out_features,
            model.outputs[0].lin_up.out_features, model.num_spherical,
            model.num_radial, model.cutoff, model.pool) == (
        jmodel.num_layers, jmodel.hidden_channels, jmodel.int_emb_size,
        jmodel.basis_emb_size, jmodel.out_emb_channels, jmodel.num_spherical,
        jmodel.num_radial, jmodel.cutoff, jmodel.pool)
    # GlorotOrthogonal: an orthogonal matrix scaled to variance 2/(in+out)
    w = inter.lin_ji.weight.detach().double()
    assert abs(w.var(unbiased=False).item() - 2 / 256) < 1e-6
    torch.testing.assert_close(w @ w.T / (w @ w.T)[0, 0],
                               torch.eye(128, dtype=torch.float64),
                               atol=1e-5, rtol=0)
    assert not model.outputs[0].lin.weight.any()
    emb = model.emb.emb.weight
    assert 0 <= emb.min() and emb.max() < 2 * np.sqrt(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dimenet.DimeNetPPModel()


def _jax_epoch_orders(seed, m, n_epochs):
    """The permutations the JAX resident engine draws."""
    _, shuffle_key = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.permutation(
        jax.random.fold_in(shuffle_key, e), m)) for e in range(n_epochs)]


def test_fit_regression_tracks_jax_for_3_epochs():
    jdata = jds.create_star_graphs(num=40, fold=(5, 6, 7), seed=0)
    tdata = tds.create_star_graphs(num=40, fold=(5, 6, 7), seed=0)
    jsplit = jgraph.random_split(jdata, [0.5, 0.2, 0.3], seed=0)
    tsplit = tgraph.random_split(tdata, [0.5, 0.2, 0.3], seed=0)
    pad = jgraph.pad_sizes(jdata, 8)
    kw = dict(pad=pad, with_triplets=True)
    jl = (jgraph.GraphLoader(jsplit[0], 8, shuffle=True, seed=0, **kw),
          jgraph.GraphLoader(jsplit[1], 8, **kw),
          jgraph.GraphLoader(jsplit[2], 8, **kw))
    tl = (tgraph.GraphLoader(tsplit[0], 8, shuffle=True, seed=0, **kw),
          tgraph.GraphLoader(tsplit[1], 8, **kw),
          tgraph.GraphLoader(tsplit[2], 8, **kw))
    jmodel, variables, tmodel = _bridged(KW, next(iter(jl[0])))
    jres = jtrain.fit_regression(jmodel, variables, *jl, n_epochs=3, lr=5e-4,
                                 seed=0)
    orders = _jax_epoch_orders(0, len(jsplit[0]), 3)
    tres = ttrain.fit_regression(
        tmodel, None, *tl, n_epochs=3, lr=5e-4, seed=0, device="cpu",
        epoch_order=lambda e: torch.from_numpy(orders[e]))
    np.testing.assert_allclose(tres.perf_per_epoch, jres.perf_per_epoch,
                               atol=1e-4, rtol=0)
    want = dimenet_from_jax(jax.tree.map(np.asarray, jres.variables))
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(tres.variables[name].numpy(), w, rtol=0,
                                   atol=max(2e-4, 1e-6 * np.abs(w).max()),
                                   err_msg=name)


def test_bench_scale_row_steps_on_a_small_box():
    """``bench_scale``'s dimenet row: the box with its triplets, the
    configuration (triplet_chunk 262144; from 100k atoms edge chunks of
    65536, remat_blocks and rbf_in_chunk) and one step on the CPU, its
    triplet count in the row's terms."""
    from geometric_message_passing_tpu_torch.experiments import bench_scale

    assert bench_scale.config("dimenet", 30_000) == dict(
        num_layers=4, triplet_chunk=262144)
    assert bench_scale.config("dimenet", 100_000) == dict(
        num_layers=4, triplet_chunk=262144, remat_blocks=True,
        edge_chunk=65536, rbf_in_chunk=True)
    box = bench_scale.box_batch(120, sort=False, triplets=True)
    assert box.triplets is not None
    assert bool((box.triplets.idx_ji.diff() >= 0).all())
    cfg = dict(bench_scale.config("dimenet", 120), hidden_channels=16,
               int_emb_size=8, out_emb_channels=16,
               triplet_chunk=box.triplets.num_triplets // 2)
    model = bench_scale.build("dimenet", cfg, torch.Generator().manual_seed(0),
                              "cpu")
    loss = bench_scale.make_step(model, box)()
    assert np.isfinite(loss.item())
    assert (bench_scale.model_steps("dimenet", 40) == 4
            and bench_scale.model_steps("dimenet", 4) == 2)
