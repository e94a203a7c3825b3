"""The port's EGNNFusedModel against the JAX package's, with the JAX
model's weights carried over by ``weights.egnn_fused_from_jax``.  The JAX
model on the CPU takes its XLA twin of the fused kernel; the port on the CPU
takes the plain version of its CUDA kernel."""

import jax
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models.egnn_fused import (
    EGNNFusedModel as JaxEGNNFusedModel)
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.models.egnn_fused import (
    EGNNFusedModel)
from geometric_message_passing_tpu_torch.weights import egnn_fused_from_jax

ATOL, RTOL = 1e-5, 1e-4   # f32 through 2 layers, summation order differs


def _graphs(in_dim, seed=0, num=10):
    graphs = tds.create_star_graphs(num=num, fold=(4, 5, 6), seed=seed)
    rng = np.random.default_rng(seed)
    for g in graphs:   # node types, so the embedding table is exercised
        g.atoms = rng.integers(0, in_dim, g.num_nodes).astype(np.int32)
    return graphs


def _bridged(jax_kwargs, graphs, batch_size, seed=0):
    """(JAX model, its variables, the port's model with the same weights)."""
    pad = jgraph.pad_sizes(graphs, batch_size)
    jbatch = jgraph.batch_graphs(graphs[:batch_size], *pad)
    jmodel = JaxEGNNFusedModel(**jax_kwargs)
    variables = jmodel.init(jax.random.PRNGKey(seed), jbatch)
    tmodel = EGNNFusedModel(**jax_kwargs, device="cpu")
    tmodel.load_state_dict(
        egnn_fused_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("emb_dim", [16, 32])
@pytest.mark.parametrize("pool", ["first", "sum", "mean"])
def test_forward_matches_jax(pool, emb_dim):
    kw = dict(num_layers=2, emb_dim=emb_dim, in_dim=3, out_dim=2, pool=pool)
    graphs = _graphs(kw["in_dim"])
    jmodel, variables, tmodel = _bridged(kw, graphs, batch_size=6)
    pad = jgraph.pad_sizes(graphs, 6)
    for chunk in (graphs[:6], graphs[6:]):   # a full and a partial batch
        want = np.asarray(jmodel.apply(variables,
                                       jgraph.batch_graphs(chunk, *pad)))
        with torch.no_grad():
            got = tmodel(tgraph.batch_graphs(chunk, *pad)).numpy()
        assert got.shape == want.shape == (7, 2)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", [dict(residual=False),
                                     dict(equivariant_pred=True)])
def test_model_options_match_jax(variant):
    kw = dict(num_layers=2, emb_dim=16, in_dim=2, out_dim=1, pool="sum",
              **variant)
    graphs = _graphs(kw["in_dim"], seed=1, num=5)
    jmodel, variables, tmodel = _bridged(kw, graphs, batch_size=5, seed=1)
    pad = jgraph.pad_sizes(graphs, 5)
    want = np.asarray(jmodel.apply(variables, jgraph.batch_graphs(graphs, *pad)))
    with torch.no_grad():
        got = tmodel(tgraph.batch_graphs(graphs, *pad)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_bridge_covers_every_parameter():
    kw = dict(num_layers=3, emb_dim=16, in_dim=1, out_dim=1, pool="first")
    graphs = _graphs(1, num=4)
    _, variables, tmodel = _bridged(kw, graphs, batch_size=4)
    sd = egnn_fused_from_jax(jax.tree.map(np.asarray, variables))
    assert set(sd) == set(tmodel.state_dict())
    for key, value in tmodel.state_dict().items():
        assert sd[key].shape == value.shape, key


def test_layer_packed_matches_jax_rows():
    from geometric_message_passing_tpu.models.egnn_fused import FusedEGNNLayer

    kw = dict(num_layers=1, emb_dim=16, in_dim=1, out_dim=1, pool="first")
    graphs = _graphs(1, num=3)
    _, variables, tmodel = _bridged(kw, graphs, batch_size=3)
    d = 16
    b = jgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 3))
    h = np.zeros((b.num_nodes, d), np.float32)
    packed = FusedEGNNLayer(d).apply(
        {"params": variables["params"]["conv_0"]}, h, b.pos, b.senders,
        b.receivers, b.edge_mask, packed_only=True)
    with torch.no_grad():
        ours = tmodel.convs[0].packed().numpy()
    assert np.array_equal(ours, np.asarray(packed)[: 4 * d + 12])


def test_init_is_seeded_and_torch_linear_distributed():
    a = EGNNFusedModel(2, 32, 1, 1, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    b = EGNNFusedModel(2, 32, 1, 1, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    c = EGNNFusedModel(2, 32, 1, 1, device="cpu",
                       generator=torch.Generator().manual_seed(4))
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    assert not torch.equal(a.convs[0].msg_w1, c.convs[0].msg_w1)
    bound = 1 / np.sqrt(2 * 32 + 1)
    w1 = a.convs[0].msg_w1
    assert w1.abs().max() <= bound and w1.abs().max() > 0.9 * bound
    assert torch.equal(a.convs[0].msg_ln1_scale, torch.ones(32))
    assert torch.equal(a.convs[0].msg_ln1_bias, torch.zeros(32))


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EGNNFusedModel()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EGNNFusedModel(device="cuda")


def test_unknown_pool_raises():
    with pytest.raises(ValueError):
        EGNNFusedModel(1, 16, pool="max", device="cpu")
