"""The port's ``experiments/bench_throughput.py`` against the JAX script
``scripts/bench_throughput.py`` (its table and its batch, with triplets and
quads for the directional rows), its train step at full width on the CPU,
the rows ported after the table (``mace``, ``dimenet``, ``spherenet``), and
the bench's ``GMP_BENCH_MODEL`` switch (``experiments/bench.py``)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import triplets as jtriplets
from geometric_message_passing_tpu_torch.experiments import bench
from geometric_message_passing_tpu_torch.experiments import bench_throughput as bt
from geometric_message_passing_tpu_torch.models import (DimeNetPPModel,
                                                        EGNNFusedModel,
                                                        EGNNModel, GVPGNNModel,
                                                        MACEModel, SchNetModel,
                                                        SphereNetModel,
                                                        TFNModel)

ROOT = Path(__file__).resolve().parent.parent


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_throughput", ROOT / "scripts" / "bench_throughput.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_table_is_the_jax_scripts():
    assert bt.MODELS == _jax_script().MODELS


def test_batch_is_the_jax_scripts():
    data = jds.create_star_graphs(num=100, fold=[5, 6, 7], dim=3, target="max",
                                  seed=0)
    jbatch = next(iter(jgraph.GraphLoader(data, batch_size=100,
                                          pad=jgraph.pad_sizes(data, 100))))
    batch = bt.star_batch(device="cpu")
    assert int(batch.edge_mask.sum()) == int(np.asarray(jbatch.edge_mask).sum())
    for name in ("senders", "receivers", "edge_mask", "pos", "y"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)))


@pytest.mark.parametrize("name", ["mace", "dimenet", "spherenet"])
def test_unported_rows_raise_by_name(name):
    """The rows that were not ported when the table came (``mace``, then
    ``dimenet`` and ``spherenet``) now build at their full default widths
    (``mace``: 2 layers, max_ell 3, correlation 3) and take one CPU step on
    their batch."""
    model = bt.build(name, torch.Generator().manual_seed(0), "cpu")
    if name == "mace":
        assert isinstance(model, MACEModel)
        assert (len(model.convs), model.max_ell, model.correlation,
                model.emb_dim) == (2, 3, 3, 64)
    num = 2 if name == "mace" else 4
    batch = bt.star_batch(num=num, batch_size=num, device="cpu", name=name)
    loss = bt.make_step(model, batch)()
    assert np.isfinite(loss.item())


@pytest.mark.parametrize("name,quads", [("dimenet", False),
                                        ("spherenet", True)])
def test_directional_batch_is_the_jax_scripts(name, quads):
    jtriplets._TRIPLET_CACHE.clear()      # keyed on id(graph): no stale ids
    data = jds.create_star_graphs(num=100, fold=[5, 6, 7], dim=3, target="max",
                                  seed=0)
    jbatch = next(iter(jgraph.GraphLoader(
        data, batch_size=100, pad=jgraph.pad_sizes(data, 100),
        with_triplets=True, with_quads=quads,
        triplet_pad=jtriplets.triplet_pad_sizes(data, 100, quads))))
    batch = bt.star_batch(device="cpu", name=name)
    names = ["idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji", "t_mask"]
    names += ["q_trip", "q_kn", "q_mask"] if quads else []
    for field in names:
        np.testing.assert_array_equal(getattr(batch.triplets, field).numpy(),
                                      np.asarray(getattr(jbatch.triplets, field)))
    assert (batch.triplets.q_trip is None) == (not quads)


def test_unknown_row_raises():
    with pytest.raises(ValueError, match="unknown model"):
        bt.main(["egnn_sorted"])


def test_default_rows_are_the_ported_ones_and_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bt.main([])


@pytest.mark.parametrize("name,cls,extra", [
    ("schnet", SchNetModel, {}), ("egnn", EGNNModel, {}),
    ("egnn_fused", EGNNFusedModel, {"fuse_stack": False}),
    ("egnn_stack", EGNNFusedModel, {"fuse_stack": True}),
    ("gvp", GVPGNNModel, {}),
    ("tfn", TFNModel, {"max_ell": 3, "emb_dim": 64}),
    ("dimenet", DimeNetPPModel, {"num_spherical": 7, "num_radial": 6}),
    ("spherenet", SphereNetModel, {"torsion_fold": "widekey"}),
])
def test_ported_rows_build_and_step_on_cpu(name, cls, extra):
    model = bt.build(name, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(model, cls)
    assert all(getattr(model, k) == v for k, v in extra.items())
    # TFN at full width: 143,360 edge weights per edge and layer, so 2 graphs
    num = 2 if name == "tfn" else 8
    batch = bt.star_batch(num=num, batch_size=num, device="cpu", name=name)
    with torch.no_grad():
        assert model(batch).shape == (batch.num_graphs, 1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = bt.make_step(model, batch)
    losses = [step().item() for _ in range(2)]
    assert model.training and np.isfinite(losses).all()
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())


def test_stack_row_steps_as_the_per_layer_row():
    batch = bt.star_batch(num=8, batch_size=8, device="cpu")
    losses = []
    for name in ("egnn_fused", "egnn_stack"):
        step = bt.make_step(bt.build(name, torch.Generator().manual_seed(0),
                                     "cpu"), batch)
        losses.append([step().item() for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize("value,cls", [(None, EGNNFusedModel),
                                       ("egnn_fused", EGNNFusedModel),
                                       ("egnn", EGNNModel)])
def test_bench_model_switch(monkeypatch, value, cls):
    if value is None:
        monkeypatch.delenv("GMP_BENCH_MODEL", raising=False)
    else:
        monkeypatch.setenv("GMP_BENCH_MODEL", value)
    model = bench.bench_model(torch.Generator().manual_seed(0), device="cpu")
    assert type(model) is cls
    assert (model.num_layers, model.emb_dim, model.pool) == (4, 128, "first")
