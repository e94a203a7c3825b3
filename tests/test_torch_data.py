"""The port's data layer against the JAX package's: star graphs, padding,
batches, loader order and splits must be bitwise equal."""

import dataclasses

import numpy as np
import pytest

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph

STAR_CASES = [
    # seed, fold, dim, target
    (0, (3,), 3, "max"),
    (0, (5, 6, 7), 3, "max"),
    (1, (5, 6, 7), 3, "mean"),
    (7, (4, 9), 2, "max"),
    (3, (5,), 2, "mean"),
]

BATCH_FIELDS = [f.name for f in dataclasses.fields(tgraph.GraphBatch)]


def _assert_same_batch(jb, tb):
    for name in BATCH_FIELDS:
        if getattr(tb, name) is None:     # triplets: absent in both
            assert getattr(jb, name) is None, name
            continue
        a = np.asarray(getattr(jb, name))
        b = getattr(tb, name).numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("seed,fold,dim,target", STAR_CASES)
def test_star_graphs_bitwise(seed, fold, dim, target):
    jg = jds.create_star_graphs(num=25, fold=fold, dim=dim, target=target,
                                seed=seed)
    tg = tds.create_star_graphs(num=25, fold=fold, dim=dim, target=target,
                                seed=seed)
    assert len(jg) == len(tg) == 25
    for a, b in zip(jg, tg):
        for field in ("atoms", "edge_index", "pos", "y"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("batch_size", [1, 7, 100])
def test_pad_sizes_equal(batch_size):
    graphs = tds.create_star_graphs(num=30, fold=(4, 5, 9), seed=2)
    assert tgraph.pad_sizes(graphs, batch_size) == jgraph.pad_sizes(
        graphs, batch_size)


def test_bench_bucket():
    graphs = tds.create_star_graphs(num=1400, fold=(5, 6, 7), seed=0)
    assert tgraph.pad_sizes(graphs, 100) == (808, 1408, 101)


@pytest.mark.parametrize("n_graphs", [1, 6, 10])
def test_batch_graphs_equal(n_graphs):
    graphs = tds.create_star_graphs(num=10, fold=(4, 6), seed=4)[:n_graphs]
    pad = jgraph.pad_sizes(graphs, 10)
    _assert_same_batch(jgraph.batch_graphs(graphs, *pad),
                       tgraph.batch_graphs(graphs, *pad))


def test_batch_graphs_padding_conventions():
    graphs = tds.create_star_graphs(num=3, fold=(5,), seed=0)
    n_pad, e_pad, g_pad = tgraph.pad_sizes(graphs, 4)
    b = tgraph.batch_graphs(graphs, n_pad, e_pad, g_pad)
    n_edges = sum(g.num_edges for g in graphs)
    assert (b.senders[n_edges:] == n_pad - 1).all()
    assert (b.receivers[n_edges:] == n_pad - 1).all()
    assert not b.edge_mask[n_edges:].any()
    assert (b.first_node[3:] == n_pad - 1).all()
    with pytest.raises(ValueError):
        tgraph.batch_graphs(graphs, n_pad, e_pad, 3)   # no room for a pad graph


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_order_equal(shuffle, seed):
    graphs = tds.create_star_graphs(num=23, fold=(4, 5), seed=seed)
    jl = jgraph.GraphLoader(graphs, batch_size=6, shuffle=shuffle, seed=seed)
    tl = tgraph.GraphLoader(graphs, batch_size=6, shuffle=shuffle, seed=seed)
    assert len(jl) == len(tl) == 4 and tl.pad == jl.pad
    for _epoch in range(2):   # the rng advances across epochs in both
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 4
        for jb, tb in zip(jbs, tbs):
            _assert_same_batch(jb, tb)


@pytest.mark.parametrize("seed", [0, 1, 11])
def test_random_split_membership(seed):
    data = list(range(57))
    fr = [0.5, 0.2, 0.3]
    assert tgraph.random_split(data, fr, seed=seed) == jgraph.random_split(
        data, fr, seed=seed)


def test_to_undirected_equal():
    ei = np.array([[0, 0, 2, 1], [1, 2, 0, 3]], np.int32)
    assert np.array_equal(tgraph.to_undirected(ei), jgraph.to_undirected(ei))


def test_graph_batch_to_keeps_fields():
    graphs = tds.create_star_graphs(num=4, fold=(3,), seed=0)
    b = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 4))
    moved = b.to("cpu")
    assert moved.num_nodes == b.num_nodes and moved.num_graphs == 5
    for name in BATCH_FIELDS:
        if getattr(b, name) is None:      # no triplets: None stays None
            assert getattr(moved, name) is None, name
            continue
        assert getattr(moved, name).dtype == getattr(b, name).dtype
