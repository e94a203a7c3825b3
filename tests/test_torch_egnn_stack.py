"""The port's whole-stack EGNN (``ops/egnn_stack.py``, K6's plain versions)
and ``EGNNFusedModel(fuse_stack=True)`` against the JAX package: the plain
forward against ``egnn_stack_xla``, the plain backward against ``jax.vjp`` of
it and against the Pallas stack kernels in interpret mode, the autograd
function on the CPU, and the model, its gradients and ``Predictor`` against
the JAX model of the same strategy with carried weights.  The CUDA kernels
themselves are held against the plain versions in ``test_torch_cuda.py``,
on a card.

Tolerances: outputs to 2e-5 absolute (f32 through 2-3 layers, sums in
another order); feature cotangents to 1e-5 absolute; each layer's weight
gradient, a sum over all edges and nodes, to 1e-5 of its largest entry;
the interpret-mode Pallas kernels to the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments.infer import (
    Predictor as JaxPredictor)
from geometric_message_passing_tpu.models.egnn_fused import (
    EGNNFusedModel as JaxEGNNFusedModel, FusedEGNNLayer as JaxFusedEGNNLayer)
from geometric_message_passing_tpu.ops.pallas_egnn_stack import (
    egnn_stack_xla, make_egnn_stack_fused)
from geometric_message_passing_tpu.ops.pallas_egnn_stack import (
    stack_rows as jax_stack_rows)
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.experiments.train import fit_regression
from geometric_message_passing_tpu_torch.models import egnn_fused
from geometric_message_passing_tpu_torch.models.egnn_fused import EGNNFusedModel
from geometric_message_passing_tpu_torch.ops import egnn_stack as es
from geometric_message_passing_tpu_torch.weights import egnn_fused_from_jax

OUT_ATOL = 2e-5
ATOL = 1e-5
W_REL = 1e-5


def _stack_inputs(seed=0, n=30, e=110, d=16, n_layers=3, masked=0.15,
                  self_loops=0):
    """``tests/test_pallas.py``'s stack setup (LayerNorm scale rows at 1),
    with cotangents."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    recv[:self_loops] = send[:self_loops]       # live zero-length edges
    emask = rng.random(e) > masked
    w = (rng.normal(size=(n_layers, es.stack_rows(d), d)) * 0.1).astype(np.float32)
    for row in (2 * d + 2, 3 * d + 5, 4 * d + 8, 6 * d + 13, 7 * d + 16):
        w[:, row, :] = 1.0
    return dict(send=send, recv=recv, emask=emask, h=h, pos=pos, w=w,
                gh=rng.normal(size=(n, d)).astype(np.float32),
                gpos=rng.normal(size=(n, 3)).astype(np.float32),
                n_layers=n_layers)


def _star_inputs(seed=0, d=32, n_layers=3):
    """A padded star batch (masked pad edges are self-loops on node n-1)."""
    graphs = jds.create_star_graphs(num=12, fold=(5, 6, 7), seed=seed)
    b = jgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 12))
    x = _stack_inputs(seed, b.num_nodes, b.num_edges, d, n_layers)
    x.update(send=np.array(b.senders), recv=np.array(b.receivers),
             emask=np.array(b.edge_mask), pos=np.array(b.pos))
    return x


CASES = {
    "random_30x110_d16_l3": lambda: _stack_inputs(0),
    "random_self_loops_d16_l2": lambda: _stack_inputs(1, 20, 70, 16, 2,
                                                      masked=0.3, self_loops=6),
    "random_d48_l1": lambda: _stack_inputs(2, 25, 90, 48, 1),
    "star_batch_d32_l3": lambda: _star_inputs(0),
}
FWD = ("send", "recv", "emask", "h", "pos", "w")


def _torch(x, keys):
    return tuple(torch.from_numpy(np.asarray(x[k])) for k in keys)


def _jax(x, keys):
    return tuple(jnp.asarray(x[k]) for k in keys)


def _jax_vjp(fn, x):
    send, recv, emask = _jax(x, ("send", "recv", "emask"))

    @jax.jit
    def vjp(h, p, w, gh, gpos):
        return jax.vjp(lambda *a: fn(send, recv, emask, *a), h, p, w)[1](
            (gh, gpos))

    return vjp(*_jax(x, ("h", "pos", "w", "gh", "gpos")))


def _assert_grads(got, want, atol=ATOL, w_rel=W_REL):
    for g, w, name in zip(got, want, ("dh0", "dpos0", "dW")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name == "dW":
            for layer, (gl, wl) in enumerate(zip(g, w)):
                np.testing.assert_allclose(gl, wl, atol=w_rel * np.abs(wl).max(),
                                           rtol=0, err_msg=f"dW[{layer}]")
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def test_stack_rows_match_jax():
    assert [es.stack_rows(d) for d in (16, 128)] == [jax_stack_rows(d)
                                                     for d in (16, 128)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_xla(case):
    x = CASES[case]()
    want = jax.jit(egnn_stack_xla, static_argnums=6)(*_jax(x, FWD), x["n_layers"])
    got = es.egnn_stack_plain(*_torch(x, FWD), x["n_layers"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OUT_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_xla_vjp(case):
    x = CASES[case]()
    want = _jax_vjp(lambda *a: egnn_stack_xla(*a, x["n_layers"]), x)
    got = es.egnn_stack_bwd_plain(*_torch(x, FWD), x["n_layers"],
                                  *_torch(x, ("gh", "gpos")))
    _assert_grads(got, want)


@pytest.mark.parametrize("case", ["random_30x110_d16_l3",
                                  "random_self_loops_d16_l2"])
def test_plain_matches_pallas_stack_interpret(case):
    x = CASES[case]()
    fused = make_egnn_stack_fused(x["h"].shape[1], x["n_layers"],
                                  interpret=True, pallas_bwd=True)
    want = fused(*_jax(x, FWD))
    got = es.egnn_stack_plain(*_torch(x, FWD), x["n_layers"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OUT_ATOL,
                                   rtol=0)
    _assert_grads(es.egnn_stack_bwd_plain(*_torch(x, FWD), x["n_layers"],
                                          *_torch(x, ("gh", "gpos"))),
                  _jax_vjp(fused, x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_function_matches_autograd_of_plain(case):
    x = CASES[case]()
    send, recv, emask, h, pos, w = _torch(x, FWD)
    gh, gpos = _torch(x, ("gh", "gpos"))
    grads = []
    for fn in (es.egnn_stack, es.egnn_stack_plain):
        leaves = [t.clone().requires_grad_() for t in (h, pos, w)]
        ho, po = fn(send, recv, emask, *leaves, x["n_layers"])
        grads.append(torch.autograd.grad((ho * gh).sum() + (po * gpos).sum(),
                                         leaves))
    _assert_grads(grads[0], grads[1])


def test_autograd_counts_no_launch_on_cpu_and_takes_missing_cotangents():
    x = CASES["random_30x110_d16_l3"]()
    send, recv, emask, h, pos, w = _torch(x, FWD)
    w.requires_grad_()
    before = (es.egnn_stack.launches, es.egnn_stack.bwd_launches)
    ho, _ = es.egnn_stack(send, recv, emask, h, pos, w, 3)
    (dw,) = torch.autograd.grad(ho.sum(), [w])      # pos output unused
    want = es.egnn_stack_bwd_plain(send, recv, emask, h, pos, w.detach(), 3,
                                   torch.ones_like(h), torch.zeros_like(pos))
    assert torch.equal(dw, want[2])
    assert (es.egnn_stack.launches, es.egnn_stack.bwd_launches) == before


def test_serving_path_under_inference_mode():
    args = _torch(CASES["random_30x110_d16_l3"](), FWD)
    with torch.inference_mode():
        got = es.egnn_stack(*args, 3)
    for g, w in zip(got, es.egnn_stack_plain(*args, 3)):
        assert torch.equal(g, w) and not g.requires_grad


def test_residual_false_raises():
    args = _torch(CASES["random_30x110_d16_l3"](), FWD)
    with pytest.raises(ValueError, match="residual"):
        es.egnn_stack(*args, 3, residual=False)
    with pytest.raises(ValueError, match="residual"):
        es.egnn_stack_plain(*args, 3, residual=False)
    with pytest.raises(ValueError, match="residual"):
        EGNNFusedModel(2, 16, residual=False, fuse_stack=True, device="cpu")


def test_wrong_weight_shape_raises_before_the_card():
    x = CASES["random_30x110_d16_l3"]()
    send, recv, emask, h, pos, w = _torch(x, FWD)
    with pytest.raises(ValueError, match="Wall shape"):
        es._check_stack_inputs(send, recv, emask, h, pos, w[:, :-1].contiguous(), 3)
    with pytest.raises(ValueError, match="Wall shape"):
        es._check_stack_inputs(send, recv, emask, h, pos, w, 2)


# ---------------------------------------------------------------------------
# EGNNFusedModel(fuse_stack=True)
# ---------------------------------------------------------------------------


def _graphs(num=10, seed=5):
    return jds.create_star_graphs(num=num, fold=(5, 6, 7), seed=seed)


def _bridged(kw, graphs, jax_fuse, port_fuse, seed=7):
    """(JAX model of strategy jax_fuse, its variables, the port's model of
    strategy port_fuse with the same weights)."""
    pad = jgraph.pad_sizes(graphs, len(graphs))
    jmodel = JaxEGNNFusedModel(**kw, fuse_stack=jax_fuse)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jgraph.batch_graphs(graphs, *pad))
    tmodel = EGNNFusedModel(**kw, fuse_stack=port_fuse, device="cpu")
    tmodel.load_state_dict(
        egnn_fused_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, tmodel


KW = dict(num_layers=3, emb_dim=32, in_dim=1, out_dim=1, pool="first")


@pytest.mark.parametrize("jax_fuse,port_fuse", [(True, True), (False, True),
                                                (True, False)])
def test_model_matches_jax_across_strategies(jax_fuse, port_fuse):
    graphs = _graphs()
    jmodel, variables, tmodel = _bridged(KW, graphs, jax_fuse, port_fuse)
    pad = jgraph.pad_sizes(graphs, len(graphs))
    want = np.asarray(jmodel.apply(variables, jgraph.batch_graphs(graphs, *pad)))
    with torch.no_grad():
        got = tmodel(tgraph.batch_graphs(graphs, *pad)).numpy()
    assert got.shape == want.shape == (len(graphs) + 1, 1)
    np.testing.assert_allclose(got, want, atol=OUT_ATOL, rtol=1e-4)


@pytest.mark.parametrize("pool", ["first", "sum"])
def test_model_gradients_match_jax_grad(pool):
    kw = dict(KW, pool=pool)
    graphs = _graphs()
    jmodel, variables, tmodel = _bridged(kw, graphs, True, True)
    pad = jgraph.pad_sizes(graphs, len(graphs))
    jbatch = jgraph.batch_graphs(graphs, *pad)

    def loss_of(params):
        pred = jmodel.apply({"params": params}, jbatch)
        return jnp.sum(jnp.abs(pred - jbatch.y) * jbatch.graph_mask[:, None])

    want = egnn_fused_from_jax(
        {"params": jax.tree.map(np.asarray, jax.grad(loss_of)(variables["params"]))})
    tbatch = tgraph.batch_graphs(graphs, *pad)
    loss = ((tmodel(tbatch) - tbatch.y).abs() * tbatch.graph_mask[:, None]).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_of(variables["params"])),
                               rtol=1e-5)
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=max(ATOL, W_REL * np.abs(w).max()),
                                   rtol=0, err_msg=name)


def test_stack_matches_per_layer_in_the_port():
    graphs = _graphs(num=8, seed=3)
    batch = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 8))
    models = [EGNNFusedModel(**KW, fuse_stack=f, device="cpu",
                             generator=torch.Generator().manual_seed(4))
              for f in (False, True)]
    outs, grads = [], []
    for m in models:
        out = m(batch)
        out.sum().backward()
        outs.append(out.detach())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    torch.testing.assert_close(outs[1], outs[0], atol=OUT_ATOL, rtol=1e-4)
    for name, g in grads[0].items():
        torch.testing.assert_close(
            grads[1][name], g, atol=max(ATOL, W_REL * g.abs().max().item()),
            rtol=0)


def test_stack_packed_matches_jax_rows():
    graphs = _graphs(num=3)
    _, variables, tmodel = _bridged(KW, graphs, True, True)
    d = KW["emb_dim"]
    b = jgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 3))
    for i, conv in enumerate(tmodel.convs):
        packed = JaxFusedEGNNLayer(d).apply(
            {"params": variables["params"][f"conv_{i}"]},
            np.zeros((b.num_nodes, d), np.float32), b.pos, b.senders,
            b.receivers, b.edge_mask, packed_only=True)
        with torch.no_grad():
            ours = conv.stack_packed().numpy()
        assert ours.shape == (es.stack_rows(d), d)
        assert np.array_equal(ours, np.asarray(packed))


def test_predictor_matches_jax_predictor():
    graphs = _graphs(num=23, seed=6)
    jmodel, variables, tmodel = _bridged(KW, graphs[:8], True, True)
    want = JaxPredictor(jmodel, variables, batch_size=8).predict(graphs)
    got = Predictor(tmodel, batch_size=8, device="cpu").predict(graphs)
    assert got.shape == want.shape == (23, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=OUT_ATOL, rtol=1e-4)


def test_fit_regression_trains_the_stack(monkeypatch):
    """fit_regression's copy keeps fuse_stack: every forward goes through
    egnn_stack, and the run follows the per-layer strategy's."""
    graphs = _graphs(num=20, seed=8)
    loaders = [tgraph.GraphLoader(graphs[a:b], batch_size=4,
                                  pad=tgraph.pad_sizes(graphs, 4), **kw)
               for (a, b), kw in (((0, 12), dict(shuffle=True, seed=0)),
                                  ((12, 16), {}), ((16, 20), {}))]
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return es.egnn_stack(*args, **kwargs)

    monkeypatch.setattr(egnn_fused, "egnn_stack", counted)
    results = {}
    for fuse in (False, True):
        calls.clear()
        model = EGNNFusedModel(2, 16, pool="first", fuse_stack=fuse,
                               device="cpu",
                               generator=torch.Generator().manual_seed(1))
        res = fit_regression(model, None, *loaders, n_epochs=2, lr=5e-4,
                             seed=0, device="cpu")
        results[fuse] = res
        best, fired = np.float32(np.inf), 0
        for val in res.perf_per_epoch[:, 1].astype(np.float32):
            if val <= best:
                best, fired = val, fired + 1
        # per epoch 3 train steps and 1 validation batch, and 1 test batch
        # in each epoch whose best-val rule fired
        assert len(calls) == (2 * (3 + 1) + fired if fuse else 0)
    np.testing.assert_allclose(results[True].train_losses,
                               results[False].train_losses, rtol=1e-4)
