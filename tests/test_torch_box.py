"""The port's box-scale data path against the JAX package's: the radius
graph (element for element, with the JAX package's C++ cell list and its
numpy twin), the molecular boxes, the receiver sort, the segment plans, and
three bench_scale training steps (``egnn_sorted``, ``schnet_sorted``,
``egnn_fused``) against the same steps in JAX with ``optax.adam(1e-4)``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments.train import l1_sum_loss as jax_l1
from geometric_message_passing_tpu.models import model_registry as jax_models
from geometric_message_passing_tpu.ops import pallas_sorted_segsum as jss
from geometric_message_passing_tpu.ops.radius_graph import (
    radius_graph as jax_radius_graph, radius_graph_python)
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import bench_scale
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss
from geometric_message_passing_tpu_torch.ops.radius_graph import radius_graph
from geometric_message_passing_tpu_torch.weights import (egnn_from_jax,
                                                         egnn_fused_from_jax,
                                                         schnet_from_jax)


@pytest.mark.parametrize("n,r,kw", [
    (400, 3.0, {}),
    (400, 3.0, dict(max_num_neighbors=5)),
    (300, 1.5, dict(batch=True)),
    (300, 2.5, dict(batch=True, max_num_neighbors=3)),
    (200, 2.0, dict(loop=True)),
    (60, 1.0, dict(coincident=True)),       # points on cell boundaries
    (50, 0.0, {}),
])
def test_radius_graph_matches_jax(n, r, kw):
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 12, (n, 3)).astype(np.float32)
    if kw.pop("coincident", False):
        pos = np.round(pos)
    if kw.pop("batch", False):
        kw["batch"] = rng.integers(0, 3, n)
    got = radius_graph(pos, r, **kw)
    assert got.dtype == np.int32 and got.shape[0] == 2
    np.testing.assert_array_equal(got, jax_radius_graph(pos, r, **kw))
    np.testing.assert_array_equal(got, radius_graph_python(pos, r, **kw))


def test_radius_graph_edge_cases():
    assert radius_graph(np.zeros((0, 3)), 1.0).shape == (2, 0)
    pos1d = np.array([0.0, 0.5, 3.0])
    np.testing.assert_array_equal(radius_graph(pos1d, 1.0), [[0, 1], [1, 0]])


@pytest.mark.parametrize("kw", [dict(n_nodes=400), dict(n_nodes=300, num=2,
                                                       max_num_neighbors=6)])
def test_molecular_boxes_match_jax(kw):
    want = jds.create_molecular_boxes(seed=0, **kw)
    got = tds.create_molecular_boxes(seed=0, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("atoms", "pos", "edge_index", "y"):
            a, b = getattr(g, field), np.asarray(getattr(w, field))
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b)


def test_sort_edges_by_receiver_matches_jax():
    (jbox,) = jds.create_molecular_boxes(n_nodes=400, seed=1)
    want = jgraph.sort_edges_by_receiver(jbox)
    got = tgraph.sort_edges_by_receiver(
        tgraph.Graph(jbox.atoms, jbox.edge_index, jbox.pos, jbox.y))
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    np.testing.assert_array_equal(got.pos, want.pos)
    assert np.all(np.diff(got.edge_index[1]) >= 0)


@pytest.mark.parametrize("sort", [True, False])
def test_batch_seg_plans_match_jax(sort):
    (box,) = tds.create_molecular_boxes(n_nodes=400, seed=2)
    if sort:
        box = tgraph.sort_edges_by_receiver(box)
    tb = next(iter(tgraph.GraphLoader([box], batch_size=1)))
    jb = next(iter(jgraph.GraphLoader(
        [jgraph.Graph(box.atoms, box.edge_index, box.pos, box.y)],
        batch_size=1)))
    plans = sss.batch_seg_plans(tb)
    n = tb.num_nodes
    for key, idx in (("rcv", jb.receivers), ("snd", jb.senders)):
        jplan = jss.build_segment_tile_plan(np.asarray(idx), n,
                                            mask=np.asarray(jb.edge_mask))
        plan = plans[key]
        np.testing.assert_array_equal(plan.perm.numpy(), jplan.perm)
        assert plan.identity_perm == jplan.cfg.identity_perm
        assert plan.num_segments == n and plan.masked
        live = int(tb.edge_mask.sum())
        assert plan.rowptr[-1] == live
        idx_t = (tb.receivers if key == "rcv" else tb.senders).long()
        counts = torch.bincount(idx_t[tb.edge_mask], minlength=n)
        assert torch.equal(plan.rowptr.diff(), counts)
    # the radius graph lists its edges by centre, which graph.Graph reads
    # as the sender: the unsorted box's sender plan is the identity
    assert plans["rcv"].identity_perm == sort
    assert plans["snd"].identity_perm == (not sort)


def test_steps_per_call_rule():
    assert [bench_scale.steps_per_call(n) for n in (10_000, 30_000, 100_000,
                                                    1_000_000)] == [40, 40, 15, 4]


def _jax_steps(name, cfg, jb, steps):
    extra = dict(use_pallas=False) if name == "egnn_fused" else {}
    model = jax_models[bench_scale.SORTED.get(name, name)](
        out_dim=1, in_dim=8, **cfg, **extra)
    variables = model.init(jax.random.PRNGKey(0), jb)
    tx = optax.adam(1e-4)
    params = variables["params"]
    state = tx.init(params)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: jax_l1(model.apply({"params": p}, jb), jb))(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    first = {"params": params}
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return first, {"params": params}, losses


@pytest.mark.parametrize("name", ["egnn_sorted", "schnet_sorted",
                                  "egnn_fused"])
def test_bench_scale_steps_match_jax(name):
    """Three of bench_scale's steps (L1-sum loss, Adam 1e-4) through the
    port's sorted path (``egnn_fused``: the plain box through the fused
    model, K1 and K2's plain versions), against the JAX model's plain path
    (``EGNNFusedModel(use_pallas=False)``) and optax."""
    cfg = dict(num_layers=2, hidden_channels=32, num_filters=32) \
        if name == "schnet_sorted" else dict(num_layers=2, emb_dim=32)
    to_torch = {"egnn_sorted": egnn_from_jax, "schnet_sorted": schnet_from_jax,
                "egnn_fused": egnn_fused_from_jax}[name]
    tb = bench_scale.kind_box(bench_scale.box_kind(name), 400)
    jb = jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in (
            "atoms", "pos", "senders", "receivers", "graph_id", "y",
            "node_mask", "edge_mask", "graph_mask", "first_node")})
    first, last, jax_losses = _jax_steps(name, cfg, jb, 3)
    model = bench_scale.build(name, cfg, torch.Generator().manual_seed(0),
                              "cpu")
    model.load_state_dict(to_torch(jax.tree.map(np.asarray, first)),
                          strict=True)
    plans = sss.batch_seg_plans(tb) if name in bench_scale.SORTED else None
    step = bench_scale.make_step(model, tb, plans)
    losses = [step().item() for _ in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=2e-5)
    want = to_torch(jax.tree.map(np.asarray, last))
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=key)


@pytest.mark.parametrize("name,layers", [("egnn_sorted", 4), ("egnn_sorted", 2),
                                         ("schnet_sorted", 4)])
def test_sorted_launches_per_step_counts_the_code(monkeypatch, name, layers):
    """On the CPU the sorted sums and the gather backwards run the plain
    version where the card launches the kernel: count those calls in one
    step, as ``chip_smoke.py`` counts the launches on the card."""
    calls = []
    plain = sss.sorted_segment_sum_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(sss, "sorted_segment_sum_plain", counted)
    cfg = dict(num_layers=layers, emb_dim=16) if name == "egnn_sorted" else \
        dict(num_layers=layers, hidden_channels=16, num_filters=16)
    tb = bench_scale.box_batch(200, sort=True)
    model = bench_scale.build(name, cfg, torch.Generator().manual_seed(0), "cpu")
    bench_scale.make_step(model, tb, sss.batch_seg_plans(tb))()
    assert len(calls) == bench_scale.sorted_launches_per_step(name, layers)
