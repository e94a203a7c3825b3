"""The port's device-resident slot data against the JAX package's:
``build_slot_data``, ``assemble_batch`` and ``eval_slot_indices`` must give
bitwise-equal arrays (integer, bool and float fields alike)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import triplets as jtri
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph

SLOT_FIELDS = [f.name for f in dataclasses.fields(tgraph.SlotData)]
BATCH_FIELDS = [f.name for f in dataclasses.fields(tgraph.GraphBatch)]


def _same(a, b, name):
    if b is None:                 # an optional field absent in both
        assert a is None, name
        return
    a = np.asarray(a)
    b = b.cpu().numpy()
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.array_equal(a, b), name


@pytest.mark.parametrize("fold,sn,se", [((5, 6, 7), None, None),
                                        ((3, 4), 9, 20)])
def test_build_slot_data_bitwise(fold, sn, se):
    graphs = tds.create_star_graphs(num=17, fold=fold, seed=1)
    jslot = jgraph.build_slot_data(
        jds.create_star_graphs(num=17, fold=fold, seed=1), sn=sn, se=se)
    tslot = tgraph.build_slot_data(graphs, sn=sn, se=se)
    for name in SLOT_FIELDS:
        _same(getattr(jslot, name), getattr(tslot, name), name)
    assert (tslot.num_graphs, tslot.slot_nodes, tslot.slot_edges) == (
        jslot.num_graphs, jslot.slot_nodes, jslot.slot_edges)


@pytest.mark.parametrize("rows", [
    [3, 0, 16, 7],             # a full batch
    [5, 2, 17, 17],            # sentinel padding (index M = 17)
    [40, 1, 12, 9],            # indices past M clamp to the sentinel
])
def test_assemble_batch_bitwise(rows):
    graphs = tds.create_star_graphs(num=17, fold=(5, 6, 7), seed=2)
    jslot = jgraph.build_slot_data(
        jds.create_star_graphs(num=17, fold=(5, 6, 7), seed=2))
    tslot = tgraph.build_slot_data(graphs)
    jb = jgraph.assemble_batch(jslot, jnp.asarray(rows, jnp.int32))
    tb = tgraph.assemble_batch(tslot, torch.tensor(rows))
    for name in BATCH_FIELDS:
        _same(getattr(jb, name), getattr(tb, name), name)
    # pad edges are masked self-loops on each slot's last node
    sn = tslot.slot_nodes
    pad = ~tb.edge_mask
    assert torch.equal(tb.senders[pad], tb.receivers[pad])
    assert bool(((tb.senders[pad] + 1) % sn == 0).all())


@pytest.mark.parametrize("num,batch", [(17, 4), (16, 4), (3, 10)])
def test_eval_slot_indices_equal(num, batch):
    got = tgraph.eval_slot_indices(num, batch)
    want = jgraph.eval_slot_indices(num, batch)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_loader_num_examples_and_unported_fields():
    """The loader's size; slot triplets (not ported before the triplet
    models) now round-trip through ``build_slot_data`` / ``assemble_batch``
    as the JAX package's do; a slot smaller than a graph raises."""
    graphs = tds.create_star_graphs(num=11, fold=(4,), seed=3)
    jgraphs = jds.create_star_graphs(num=11, fold=(4,), seed=3)
    loader = tgraph.GraphLoader(graphs, 4)
    assert loader.num_examples == 11 == jgraph.GraphLoader(
        jgraphs, 4).num_examples
    tslot = tgraph.build_slot_data(graphs, with_triplets=True)
    jtri._TRIPLET_CACHE.clear()      # keyed on id(graph): no stale entries
    jslot = jgraph.build_slot_data(jgraphs, with_triplets=True)
    rows = [3, 11, 0, 7]
    tb = tgraph.assemble_batch(tslot, torch.tensor(rows))
    jb = jgraph.assemble_batch(jslot, jnp.asarray(rows, jnp.int32))
    for name in ("idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji", "t_mask"):
        _same(getattr(jb.triplets, name), getattr(tb.triplets, name), name)
    with pytest.raises(ValueError):
        tgraph.build_slot_data(graphs, sn=3)
