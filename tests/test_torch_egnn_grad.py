"""The port's EGNN message backward against the JAX package's: the plain
backward against ``jax.vjp`` of ``egnn_message_xla`` and against the fused
Pallas backward kernel in interpret mode, the autograd function on the CPU,
and the parameter gradients of a whole 2-layer model against ``jax.grad``.
The CUDA backward kernel itself is held against the plain version in
``test_torch_cuda.py``, on a card.

Tolerances: dh and dpos to 1e-5 absolute; the packed weight gradient, a sum
over all edges, to 1e-6 of its largest entry (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models.egnn_fused import (
    EGNNFusedModel as JaxEGNNFusedModel)
from geometric_message_passing_tpu.ops.pallas_edge import (
    egnn_message_xla, make_egnn_message_fused)
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.models.egnn_fused import EGNNFusedModel
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.weights import egnn_fused_from_jax

ATOL = 1e-5
W_REL = 1e-6


def _random_inputs(n, e, d, seed, masked=0.1, self_loops=0):
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    recv[:self_loops] = send[:self_loops]      # live zero-length edges
    return dict(
        send=send, recv=recv, emask=rng.random(e) >= masked,
        h=rng.normal(size=(n, d)).astype(np.float32),
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        w=(rng.normal(size=(edge.msg_rows(d), d)) * 0.1).astype(np.float32),
        gmsg=rng.normal(size=(n, d)).astype(np.float32),
        gpos=rng.normal(size=(n, 3)).astype(np.float32),
    )


def _star_inputs(d, seed):
    """A padded star batch: masked pad edges are self-loops on node n-1."""
    graphs = jds.create_star_graphs(num=12, fold=(5, 6, 7), seed=seed)
    b = jgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 12))
    x = _random_inputs(b.num_nodes, b.num_edges, d, seed)
    x.update(send=np.array(b.senders), recv=np.array(b.receivers),
             emask=np.array(b.edge_mask), pos=np.array(b.pos))
    return x


CASES = {
    "random_40x150x32": lambda: _random_inputs(40, 150, 32, seed=1),
    "random_self_loops_d16": lambda: _random_inputs(20, 60, 16, seed=2,
                                                    masked=0.3, self_loops=6),
    "star_batch_d32": lambda: _star_inputs(32, seed=0),
}
FWD = ("send", "recv", "emask", "h", "pos", "w")


def _torch(x, keys):
    return tuple(torch.from_numpy(x[k]) for k in keys)


def _jax_vjp(fn, x):
    """(dh, dpos, dW) of ``fn(send, recv, emask, h, pos, w)``'s first two
    outputs against the cotangents in ``x``."""
    send, recv, emask = (jnp.asarray(x[k]) for k in ("send", "recv", "emask"))
    _, vjp = jax.vjp(lambda h, p, w: fn(send, recv, emask, h, p, w),
                     jnp.asarray(x["h"]), jnp.asarray(x["pos"]),
                     jnp.asarray(x["w"]))
    n = x["h"].shape[0]
    return vjp((jnp.asarray(x["gmsg"]), jnp.asarray(x["gpos"]),
                jnp.zeros((n, 1), jnp.float32)))


def _assert_grads(got, want):
    for g, w, name in zip(got, want, ("dh", "dpos", "dW")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        atol = W_REL * np.abs(w).max() if name == "dW" else ATOL
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_xla_vjp(case):
    x = CASES[case]()
    d = x["h"].shape[1]
    want = _jax_vjp(lambda *a: egnn_message_xla(*a, d), x)
    _assert_grads(edge.egnn_message_bwd_plain(
        *_torch(x, FWD + ("gmsg", "gpos"))), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_plain_matches_pallas_bwd_interpret(case):
    x = CASES[case]()
    d = x["h"].shape[1]
    fused = make_egnn_message_fused(d, interpret=True, pallas_bwd=True)
    _assert_grads(edge.egnn_message_bwd_plain(
        *_torch(x, FWD + ("gmsg", "gpos"))), _jax_vjp(fused, x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_matches_autograd_of_plain(case):
    x = CASES[case]()
    send, recv, emask, h, pos, w = _torch(x, FWD)
    gmsg, gpos = _torch(x, ("gmsg", "gpos"))
    grads = []
    for fn in (edge.egnn_message, edge.egnn_message_plain):
        leaves = [t.clone().requires_grad_() for t in (h, pos, w)]
        msg, pos_sum, _ = fn(send, recv, emask, *leaves)
        grads.append(torch.autograd.grad(
            (msg * gmsg).sum() + (pos_sum * gpos).sum(), leaves))
    _assert_grads(grads[0], grads[1])


def test_autograd_function_counts_no_launch_and_takes_missing_cotangents():
    x = _random_inputs(20, 60, 16, seed=3)
    send, recv, emask, h, pos, w = _torch(x, FWD)
    h.requires_grad_()
    before = (edge.egnn_message.launches, edge.egnn_message.bwd_launches)
    msg, _, cnt = edge.egnn_message(send, recv, emask, h, pos, w)
    assert not cnt.requires_grad                  # the count has no gradient
    (dh,) = torch.autograd.grad(msg.sum(), [h])   # pos output unused
    gmsg = torch.ones_like(msg)
    want = edge.egnn_message_bwd_plain(send, recv, emask, h.detach(), pos, w,
                                       gmsg, torch.zeros_like(pos))
    assert torch.equal(dh, want[0])
    assert (edge.egnn_message.launches,
            edge.egnn_message.bwd_launches) == before


def test_serving_path_unchanged_under_inference_mode():
    x = _random_inputs(20, 60, 16, seed=4)
    args = _torch(x, FWD)
    with torch.inference_mode():
        got = edge.egnn_message(*args)
    for g, w in zip(got, edge.egnn_message_plain(*args)):
        assert torch.equal(g, w) and not g.requires_grad


def _star_graphs(num, seed):
    return jds.create_star_graphs(num=num, fold=(5, 6, 7), seed=seed)


@pytest.mark.parametrize("pool", ["first", "sum"])
def test_model_gradients_match_jax_grad(pool):
    kw = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=1, pool=pool)
    graphs = _star_graphs(10, seed=5)
    pad = jgraph.pad_sizes(graphs, 10)
    jbatch = jgraph.batch_graphs(graphs, *pad)
    jmodel = JaxEGNNFusedModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(7), jbatch)

    def loss_of(params):
        pred = jmodel.apply({"params": params}, jbatch)
        return jnp.sum(jnp.abs(pred - jbatch.y) * jbatch.graph_mask[:, None])

    jgrads = jax.grad(loss_of)(variables["params"])
    want = egnn_fused_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads)})

    tmodel = EGNNFusedModel(**kw, device="cpu")
    tmodel.load_state_dict(
        egnn_fused_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    tbatch = tgraph.batch_graphs(graphs, *pad)
    loss = ((tmodel(tbatch) - tbatch.y).abs()
            * tbatch.graph_mask[:, None]).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_of(variables["params"])),
                               rtol=1e-5)
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, atol=max(ATOL, W_REL * np.abs(w).max()),
            rtol=0, err_msg=name)
