"""The port's SphereNet (``models/spherenet.py``) against the JAX package's,
with the JAX model's weights carried over by ``weights.spherenet_from_jax``:
distances, angles and torsions (``spherenet_geometry``) with both torsion
folds, chunked and not; ``'widekey'`` against ``'atan2'``; output and every
parameter's gradient (2 layers, hidden 16, int_emb 8, bases 4, ns 3-4,
nr 3) with both folds and with ``triplet_chunk`` / ``quad_chunk``;
``Predictor`` with quads; and a 3-epoch ``fit_regression`` fed the JAX
package's epoch permutations.  On the CPU the fold (K3) and the other sums
(K4) take their plain versions.

Tolerances: outputs 1e-5 absolute / 1e-4 relative (f32 sums in another
order); torsions 5e-6 absolute (the JAX test's, widekey against atan2);
gradients 2e-4 of max(|ref|, 1) per parameter (a parameter that gets no
gradient, ``init_v``'s, whose output the first layer replaces, counts as
0); after 3 epochs the per-epoch MAEs 1e-4 and the parameters 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import triplets as jtri
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.experiments.infer import (
    Predictor as JaxPredictor)
from geometric_message_passing_tpu.models import spherenet as jsphere
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.models import (model_registry,
                                                        spherenet)
from geometric_message_passing_tpu_torch.weights import spherenet_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4
TORSION_ATOL = 5e-6
KW = dict(num_layers=2, hidden_channels=16, int_emb_size=8,
          basis_emb_size_dist=4, basis_emb_size_angle=4,
          basis_emb_size_torsion=4, out_emb_channels=16, num_spherical=3,
          num_radial=3, num_output_layers=1, out_dim=1)


@pytest.fixture(autouse=True)
def fresh_jax_triplet_cache():
    """The JAX package caches each graph's triplets under ``id(graph)``
    without keeping the graph alive, so a graph freed by an earlier test can
    hand its id, and its stale triplets, to a new one.  Start each test with
    that cache empty (the port's cache holds its graphs)."""
    jtri._TRIPLET_CACHE.clear()
    yield
    jtri._TRIPLET_CACHE.clear()


def _batches(graphs, batch_size):
    pad = jgraph.pad_sizes(graphs, batch_size)
    kw = dict(pad=pad, with_triplets=True, with_quads=True)
    jb = next(iter(jgraph.GraphLoader(graphs, batch_size, **kw)))
    tb = next(iter(tgraph.GraphLoader(graphs, batch_size, **kw)))
    return jb, tb


def _bridged(kw, jb, seed=0):
    jmodel = jsphere.SphereNetModel(**kw)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed),
                                                     jb))
    tmodel = spherenet.SphereNetModel(**kw, device="cpu")
    tmodel.load_state_dict(spherenet_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("fold", ["widekey", "atan2"])
@pytest.mark.parametrize("chunked", [False, True])
def test_geometry_matches_jax(fold, chunked):
    graphs = tds.create_star_graphs(num=6, fold=(4, 5), seed=3)
    jb, tb = _batches(graphs, 3)
    chunk = tb.triplets.q_trip.shape[0] // 4 - 1 if chunked else None
    want = jsphere.spherenet_geometry(jb, quad_chunk=chunk, torsion_fold=fold)
    got = spherenet.spherenet_geometry(tb, quad_chunk=chunk, torsion_fold=fold)
    for g, w, name in zip(got, want, ("dist", "angle", "torsion")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   atol=TORSION_ATOL, rtol=0)
    torsion = got[2][tb.triplets.t_mask]
    assert bool(((torsion > 0) & (torsion <= 2 * np.pi + 1e-6)).all())


def test_widekey_matches_atan2():
    """The pseudo-angle fold gives the atan2 fold's torsions (chunked and
    not) and the same model output and gradients."""
    graphs = tds.create_star_graphs(num=6, fold=(4, 5), seed=3)
    _, tb = _batches(graphs, 3)
    q = tb.triplets.q_trip.shape[0]
    for chunk in (None, q // 4 - 1):
        _, _, ref = spherenet.spherenet_geometry(tb, chunk, "atan2")
        _, _, new = spherenet.spherenet_geometry(tb, chunk, "widekey")
        np.testing.assert_allclose(new.numpy(), ref.numpy(), rtol=0,
                                   atol=TORSION_ATOL)
    kw = dict(KW, num_spherical=4, num_radial=4)
    m_ref = spherenet.SphereNetModel(**kw, torsion_fold="atan2", device="cpu")
    m_new = spherenet.SphereNetModel(**kw, torsion_fold="widekey", device="cpu")
    m_new.load_state_dict(m_ref.state_dict())
    out_ref, out_new = m_ref(tb), m_new(tb)
    np.testing.assert_allclose(out_new.detach().numpy(),
                               out_ref.detach().numpy(), atol=ATOL, rtol=RTOL)
    (out_ref ** 2).sum().backward()
    (out_new ** 2).sum().backward()
    for (name, p), p2 in zip(m_ref.named_parameters(), m_new.parameters()):
        if p.grad is None:
            assert p2.grad is None, name
            continue
        ref = p.grad.numpy()
        np.testing.assert_allclose(p2.grad.numpy(), ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_widekey_pins_the_coplanar_candidate_with_integer_ids():
    """k_n == k is the coplanar candidate: pinned to exactly 2 pi, found by
    comparing node ids as integers (no float32 round trip)."""
    graphs = tds.create_star_graphs(num=2, fold=(3,), seed=1)
    _, tb = _batches(graphs, 2)
    big = 2 ** 24 + 1            # a node id that float32 cannot hold
    for name in ("idx_i", "idx_j", "idx_k"):
        setattr(tb.triplets, name, getattr(tb.triplets, name).long() + big)
    tb.triplets.q_kn = tb.triplets.q_kn.long() + big
    pos = torch.zeros((big + tb.num_nodes, 3))
    pos[big:] = tb.pos
    tb.pos = pos
    tb.senders, tb.receivers = tb.senders.long() + big, tb.receivers.long() + big
    _, _, torsion = spherenet.spherenet_geometry(tb, None, "widekey")
    _, _, ref = spherenet.spherenet_geometry(tb, None, "atan2")
    np.testing.assert_allclose(torsion.numpy(), ref.numpy(), atol=TORSION_ATOL,
                               rtol=0)
    # a 3-spoke star: each triplet's candidates are k itself (2 pi) and one
    # other spoke, whose dihedral is below 2 pi
    live = torsion[tb.triplets.t_mask]
    assert bool((live < 2 * np.pi).all())


@pytest.mark.parametrize("variant", [
    dict(), dict(torsion_fold="atan2"), dict(chunked=True),
    dict(num_spherical=4, pool="mean", output_init="zeros")])
def test_model_and_gradients_match_jax(variant):
    graphs = tds.create_star_graphs(num=6, fold=(4, 5, 6), seed=0)
    jb, tb = _batches(graphs, 6)
    kw = dict(KW, **{k: v for k, v in variant.items() if k != "chunked"})
    if variant.get("chunked"):
        kw.update(triplet_chunk=tb.triplets.num_triplets // 3 - 1,
                  quad_chunk=tb.triplets.q_trip.shape[0] // 4 - 1)
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
    want_grads = spherenet_from_jax({"params": jax.tree.map(np.asarray, grads)})
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(names) == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        np.testing.assert_allclose(got, ref, err_msg=name,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_predictor_with_quads_matches_jax():
    graphs = tds.create_star_graphs(num=11, fold=(4, 5, 6), seed=7)
    jb, _ = _batches(graphs[:4], 4)
    jmodel, variables, tmodel = _bridged(KW, jb)
    y = Predictor(tmodel, batch_size=4, device="cpu",
                  with_quads=True).predict(graphs)
    want = JaxPredictor(jmodel, variables, batch_size=4,
                        with_quads=True).predict(graphs)
    assert y.shape == (11, 1) and np.isfinite(y).all()
    np.testing.assert_allclose(y, want, atol=ATOL, rtol=RTOL)


def test_registry_defaults_and_device(monkeypatch):
    assert model_registry["spherenet"] is spherenet.SphereNetModel
    model = spherenet.SphereNetModel(device="cpu")
    jmodel = jsphere.SphereNetModel()
    upd = model.update_es[0]
    assert (len(model.update_es), upd.lin_ji.in_features,
            upd.lin_down.out_features, upd.lin_t1.in_features,
            model.init_v.lin_up.out_features, len(model.init_v.lins),
            model.cutoff, model.torsion_fold, model.pool) == (
        jmodel.num_layers, jmodel.hidden_channels, jmodel.int_emb_size,
        jmodel.num_spherical ** 2 * jmodel.num_radial,
        jmodel.out_emb_channels, jmodel.num_output_layers, jmodel.cutoff,
        jmodel.torsion_fold, jmodel.pool)
    # the layers the reference leaves on torch's defaults: U(+-1/sqrt(fan_in))
    lin = model.init_e.lin
    assert lin.bias.abs().max() <= 1 / np.sqrt(3 * 128) and lin.bias.any()
    assert model.init_v.lin_up.bias.any() and not upd.lin_ji.bias.any()
    with pytest.raises(ValueError, match="torsion_fold"):
        spherenet.SphereNetModel(torsion_fold="fast", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spherenet.SphereNetModel()


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
    kw = dict(pad=pad, with_triplets=True, with_quads=True)
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
    want = spherenet_from_jax(jax.tree.map(np.asarray, jres.variables))
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(tres.variables[name].numpy(), w, rtol=0,
                                   atol=max(2e-4, 1e-6 * np.abs(w).max()),
                                   err_msg=name)
