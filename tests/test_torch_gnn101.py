"""The port's geometric-GNN-101 models (models/gnn101.py) against the JAX
package's: the three layers and three models with the JAX weights carried
by weights.gnn101_from_jax, compared in train mode (output, every
parameter's gradient of a fixed cotangent, the updated batch_stats) and in
eval mode (output), on the JAX tests' batch (3 star graphs, 2 layers x 16,
edge features drawn); then the port held to tests/test_gnn101.py's
contract, one parametrised test.

Tolerance: outputs atol = rtol = 1e-4; gradients 1e-4 of max(the tensor's
largest JAX entry, 1); running statistics rtol = 1e-4, atol = 1e-5
(float32 sums in another order, through four BatchNorms a layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import special_ortho_group

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu.graph import GraphLoader as JLoader
from geometric_message_passing_tpu.models import gnn101 as J
from geometric_message_passing_tpu.models.egnn import MPNNModel as JMPNN
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.graph import GraphLoader as TLoader
from geometric_message_passing_tpu_torch.models import gnn101 as T
from geometric_message_passing_tpu_torch.models.egnn import MPNNModel
from geometric_message_passing_tpu_torch.weights import gnn101_from_jax

TOL = 1e-4
KW = dict(num_layers=2, emb_dim=16, in_dim=2, edge_dim=4, out_dim=2)
MODELS = ["CoordMPNNModel", "InvariantMPNNModel", "FinalMPNNModel"]
LAYERS = ["MPNN101Layer", "InvariantMPNNLayer", "EquivariantMPNNLayer"]


def _graphs(pkg, rotate=None, translate=None, permute=False):
    graphs = pkg.create_star_graphs(num=3, fold=[4, 5], dim=3, seed=0)
    if rotate is not None or translate is not None:
        R = rotate if rotate is not None else np.eye(3)
        t = translate if translate is not None else np.zeros(3)
        for g in graphs:
            g.pos = (g.pos @ R.T + t).astype(np.float32)
    if permute:
        rng = np.random.default_rng(0)
        for g in graphs:
            perm = rng.permutation(g.num_nodes)
            inv = np.argsort(perm)
            g.atoms = g.atoms[perm]
            g.pos = g.pos[perm]
            g.edge_index = inv[g.edge_index]
    return graphs


def _batches(**kw):
    jb = next(iter(JLoader(_graphs(jds, **kw), batch_size=3)))
    tb = next(iter(TLoader(_graphs(tds, **kw), batch_size=3)))
    return jb, tb


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _check(label, got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol, err_msg=label)


def _check_grads(model, grads_sd):
    for name, p in model.named_parameters():
        want = grads_sd[name].numpy()
        # FinalMPNN's last scale head feeds positions nothing reads: no
        # gradient here, zeros in JAX
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= TOL * max(np.abs(want).max(), 1.0), (name, err)


def _check_stats(model, stats_sd):
    n = 0
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        n += 1
    assert n > 0


def _layer_inputs(batch, emb=16, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(batch.pos.shape[0], emb)).astype(np.float32)
    ea = rng.normal(size=(batch.senders.shape[0], 4)).astype(np.float32)
    return h, ea


@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name):
    jb, tb = _batches()
    ea = np.random.default_rng(3).normal(
        size=(jb.senders.shape[0], 4)).astype(np.float32)
    jm = getattr(J, name)(**KW)
    variables = jm.init(jax.random.PRNGKey(0), jb, ea)
    # non-trivial running statistics to start from
    variables = {**variables, "batch_stats": jax.tree.map(
        lambda v: v + 0.1, variables["batch_stats"])}
    tm = getattr(T, name)(**KW, device="cpu")
    tm.load_state_dict(gnn101_from_jax(_np(variables)), strict=True)
    ct = np.random.default_rng(4).normal(size=(jb.num_graphs, 2)).astype(
        np.float32)

    def loss(params):
        out, mut = jm.apply({**variables, "params": params}, jb, ea,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mut)

    grads, (out, mut) = jax.grad(loss, has_aux=True)(variables["params"])
    tm.train()
    got = tm(tb, torch.from_numpy(ea))
    (got * torch.from_numpy(ct)).sum().backward()
    _check("train-mode output", got, out)
    _check_grads(tm, gnn101_from_jax(_np({"params": grads, **mut})))
    _check_stats(tm, gnn101_from_jax(_np({**variables, **mut})))
    want = jm.apply({**variables, **mut}, jb, ea)
    tm.eval()
    with torch.no_grad():
        _check("eval-mode output", tm(tb, torch.from_numpy(ea)), want)


@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name):
    jb, tb = _batches()
    h, ea = _layer_inputs(jb)
    jl = getattr(J, name)(emb_dim=16)
    geo = name != "MPNN101Layer"
    jargs = ((h, jb.pos) if geo else (h,)) + (jb.senders, jb.receivers, ea,
                                              jb.edge_mask)
    variables = jl.init(jax.random.PRNGKey(1), *jargs)
    tl = getattr(T, name)(16, 4, generator=torch.Generator().manual_seed(0))
    tl.load_state_dict(gnn101_from_jax(_np(variables)), strict=True)
    ht = torch.from_numpy(h).requires_grad_()
    pos = tb.pos.clone().requires_grad_()
    targs = ((ht, pos) if geo else (ht,)) + (tb.senders, tb.receivers,
                                             torch.from_numpy(ea),
                                             tb.edge_mask)
    rng = np.random.default_rng(5)

    def outputs(o):
        return o if isinstance(o, tuple) else (o,)

    jout = outputs(jl.apply(variables, *jargs, train=True,
                            mutable=["batch_stats"])[0])
    cts = [rng.normal(size=o.shape).astype(np.float32) for o in jout]

    def loss(params, h_in, pos_in):
        args = ((h_in, pos_in) if geo else (h_in,)) + jargs[(2 if geo else 1):]
        o, mut = jl.apply({**variables, "params": params}, *args, train=True,
                          mutable=["batch_stats"])
        return sum(jnp.sum(a * c) for a, c in zip(outputs(o), cts)), (o, mut)

    (g_p, g_h, g_pos), (jo, mut) = jax.grad(
        loss, argnums=(0, 1, 2), has_aux=True)(variables["params"], h, jb.pos)
    tl.train()
    to = outputs(tl(*targs))
    sum((a * torch.from_numpy(c)).sum() for a, c in zip(to, cts)).backward()
    for a, b in zip(to, outputs(jo)):
        _check("train-mode output", a, b)
    _check("h gradient", ht.grad, g_h)
    if geo:
        _check("pos gradient", pos.grad, g_pos)
    _check_grads(tl, gnn101_from_jax(_np({"params": g_p, **mut})))
    _check_stats(tl, gnn101_from_jax(_np({**variables, **mut})))
    want = outputs(jl.apply({**variables, **mut}, *jargs))
    tl.eval()
    with torch.no_grad():
        for a, b in zip(outputs(tl(*targs)), want):
            _check("eval-mode output", a, b)


def test_mpnn_weights_go_through_gnn101_from_jax():
    """The notebook's first model, the JAX MPNNModel, through the same
    entry point (its MLPs are LayerNorm ones: mpnn_from_jax)."""
    jb, tb = _batches()
    jm = JMPNN(num_layers=2, emb_dim=16, in_dim=2, out_dim=2)
    variables = jm.init(jax.random.PRNGKey(0), jb)
    tm = MPNNModel(num_layers=2, emb_dim=16, in_dim=2, out_dim=2,
                   device="cpu")
    tm.load_state_dict(gnn101_from_jax(_np(variables)), strict=True)
    with torch.no_grad():
        _check("output", tm.eval()(tb), jm.apply(variables, jb))


def test_flax_default_init():
    """LeCun truncated normal kernels (std sqrt(1/fan_in)/0.8796, cut at two
    of them), zero biases, a fresh draw per generator seed."""
    a = T.FinalMPNNModel(**KW, device="cpu")
    b = T.FinalMPNNModel(**KW, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    w = a.layers[0].bnmlp_0.dense[0].weight.detach()
    fan_in = w.shape[1]
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    assert w.abs().max() <= 2 * std + 1e-7
    assert abs(float(w.std()) - np.sqrt(1.0 / fan_in)) < 0.25 * np.sqrt(
        1.0 / fan_in)
    assert torch.equal(a.layers[0].bnmlp_0.dense[0].bias,
                       torch.zeros_like(w[:, 0]))
    assert not torch.equal(w, b.layers[0].bnmlp_0.dense[0].weight)
    assert a.layers[0].bnmlp_0.norm[0].momentum == 0.99


def _run(cls, batch, model=None):
    model = cls(**KW, device="cpu").eval() if model is None else model
    with torch.no_grad():
        return model(batch).numpy(), model


_ROT = special_ortho_group.rvs(3, random_state=1)
_T = np.asarray([0.3, -1.2, 0.7])
CONTRACT = {
    **{f"permutation invariant {m}": (m, dict(permute=True), True)
       for m in MODELS},
    "CoordMPNNModel fails rotation invariance": (
        "CoordMPNNModel", dict(rotate=_ROT), False),
    **{f"rotation and translation invariant {m}": (
        m, dict(rotate=_ROT, translate=_T), True)
       for m in ("InvariantMPNNModel", "FinalMPNNModel")},
    "EquivariantMPNNLayer positions rotate": ("EquivariantMPNNLayer", None,
                                              True),
}


@pytest.mark.parametrize("case", list(CONTRACT))
def test_gnn101_contract(case):
    """tests/test_gnn101.py's cases on the port (weights the port's own)."""
    name, transform, holds = CONTRACT[case]
    if name == "EquivariantMPNNLayer":
        R = special_ortho_group.rvs(3, random_state=2)
        _, b = _batches()
        _, br = _batches(rotate=R)
        layer = T.EquivariantMPNNLayer(
            16, generator=torch.Generator().manual_seed(0)).eval()
        h = torch.from_numpy(np.random.default_rng(0).normal(
            size=(b.pos.shape[0], 16)).astype(np.float32))
        ea = torch.zeros((b.senders.shape[0], 4))
        with torch.no_grad():
            h1, p1 = layer(h, b.pos, b.senders, b.receivers, ea, b.edge_mask)
            h2, p2 = layer(h, br.pos, br.senders, br.receivers, ea,
                           br.edge_mask)
        np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-4)
        np.testing.assert_allclose(p1.numpy() @ np.asarray(R, np.float32).T,
                                   p2.numpy(), atol=1e-4)
        return
    cls = getattr(T, name)
    out1, model = _run(cls, _batches()[1])
    out2, _ = _run(cls, _batches(**transform)[1], model)
    assert np.allclose(out1, out2, atol=1e-4) == holds
