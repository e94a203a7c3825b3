"""The port's GVP-GNN (``models/gvpgnn.py``) against the JAX package's, with
the JAX model's weights carried over by ``weights.gvp_from_jax``: outputs
and every parameter's gradient in eval mode (JAX ``train=False``) on each
route (plain, ``use_pallas`` on the CPU = the kernels' plain versions,
``seg_plans``, ``remat``), the decoder modes of ``GVPConvLayer``, the
general-config ``GVPConv``, ``Predictor``, and the sorted kernel's count per
bench_scale step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments.infer import (
    Predictor as JaxPredictor)
from geometric_message_passing_tpu.models import gvpgnn as jgvpgnn
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import bench_scale
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.models import gvpgnn
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss
from geometric_message_passing_tpu_torch.weights import _gvp, gvp_from_jax

ATOL, RTOL = 1e-5, 1e-4   # f32 through 2 layers, summation order differs
GRAD_REL = 2e-4           # gradients: 2e-4 x max(|ref|, 1) per parameter
KW = dict(num_layers=2, s_dim=32, v_dim=4, in_dim=3, out_dim=2)
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")


def _graphs(num=8, seed=0, in_dim=3):
    graphs = tds.create_star_graphs(num=num, fold=(4, 5, 6), seed=seed)
    rng = np.random.default_rng(seed)
    for g in graphs:
        g.atoms = rng.integers(0, in_dim, g.num_nodes).astype(np.int32)
    return graphs


def _jax_batch(tb):
    return jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})


def _bridged(kw, jb, seed=0, **port_kw):
    jmodel = jgvpgnn.GVPGNNModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), jb)
    tmodel = gvpgnn.GVPGNNModel(**kw, **port_kw, device="cpu")
    tmodel.load_state_dict(gvp_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    tmodel.eval()
    return jmodel, variables, tmodel


def _jax_reference(jmodel, variables, tb):
    """The JAX model's output on ``tb``, the cotangent ``c`` and every
    parameter's gradient of sum(out * c), as a port state dict."""
    jb = _jax_batch(tb)
    c = np.random.default_rng(1).normal(
        size=(tb.num_graphs, jmodel.out_dim)).astype(np.float32)

    @jax.jit
    def run(params):
        return jax.value_and_grad(lambda p: jnp.sum(
            jmodel.apply({"params": p}, jb) * c))(params), jmodel.apply(
                {"params": params}, jb)

    (_, grads), out = run(variables["params"])
    return (np.asarray(out), c,
            gvp_from_jax({"params": jax.tree.map(np.asarray, grads)}))


@pytest.fixture(scope="module")
def star_reference():
    graphs = _graphs()
    tb = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 8))
    jmodel = jgvpgnn.GVPGNNModel(**KW)
    variables = jmodel.init(jax.random.PRNGKey(0), _jax_batch(tb))
    return tb, variables, _jax_reference(jmodel, variables, tb)


def _check_against_jax(reference, tmodel, tb, seg_plans=None):
    """Outputs and every parameter's gradient of sum(out * c)."""
    want, c, want_grads = reference
    out = tmodel(tb, seg_plans=seg_plans)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    names, params = zip(*tmodel.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(c)).sum(), params)
    assert set(names) == set(want_grads)
    for name, g in zip(names, grads):
        ref = want_grads[name].numpy()
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), ref, atol=GRAD_REL * scale,
                                   err_msg=name)


@pytest.mark.parametrize("route", [dict(), dict(use_pallas=True),
                                   dict(remat=True)])
def test_model_and_gradients_match_jax(star_reference, route):
    tb, variables, reference = star_reference
    tmodel = gvpgnn.GVPGNNModel(**KW, **route, device="cpu")
    tmodel.load_state_dict(gvp_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    _check_against_jax(reference, tmodel.eval(), tb)


def test_seg_plans_route_matches_jax():
    """On a receiver-sorted box through the sorted segment sums."""
    tb = bench_scale.box_batch(100, sort=True)
    kw = dict(KW, in_dim=8, out_dim=1)
    jmodel, variables, tmodel = _bridged(kw, _jax_batch(tb))
    _check_against_jax(_jax_reference(jmodel, variables, tb), tmodel, tb,
                       seg_plans=sss.batch_seg_plans(tb))


@pytest.mark.parametrize("variant", [dict(residual=False),
                                     dict(equivariant_pred=True, pool="mean")])
def test_model_options_match_jax(variant):
    graphs = _graphs(num=5, seed=1)
    tb = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 5))
    kw = dict(KW, **variant)
    jmodel, variables, tmodel = _bridged(kw, _jax_batch(tb), seed=1)
    want = np.asarray(jmodel.apply(variables, _jax_batch(tb)))
    with torch.no_grad():
        got = tmodel(tb).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _layer_inputs(seed=3):
    graphs = _graphs(num=3, seed=seed)
    tb = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 3))
    rng = np.random.default_rng(7)
    n, e = tb.num_nodes, tb.num_edges
    s = rng.normal(size=(n, 16)).astype(np.float32)
    v = rng.normal(size=(n, 4, 3)).astype(np.float32)
    es = rng.normal(size=(e, 8)).astype(np.float32)
    ev = rng.normal(size=(e, 1, 3)).astype(np.float32)
    return tb, (s, v), (es, ev), rng


def _port_conv_layer(variables):
    layer = gvpgnn.GVPConvLayer((16, 4), (8, 1),
                                generator=torch.Generator().manual_seed(0))
    sd = gvp_from_jax({"params": {
        "emb_in": {"embedding": np.zeros((1, 1))},
        "LayerNorm_0": {"scale": np.zeros(1), "bias": np.zeros(1)},
        "W_v": {}, "W_e": {}, "W_e_norm": {"LayerNorm_0": {
            "scale": np.zeros(1), "bias": np.zeros(1)}},
        "layer_0": jax.tree.map(np.asarray, variables["params"])}})
    layer.load_state_dict({k[len("layers.0."):]: v for k, v in sd.items()
                           if k.startswith("layers.0.")}, strict=True)
    return layer.eval()


def test_conv_layer_autoregressive_and_node_mask_match_jax():
    """GVPConvLayer's decoder modes, the JAX test's case
    (tests/test_model_equivariance.py)."""
    tb, x, edge_attr, rng = _layer_inputs()
    jb = _jax_batch(tb)
    jlayer = jgvpgnn.GVPConvLayer((16, 4), (8, 1))
    variables = jlayer.init(jax.random.PRNGKey(0), x, jb.senders, jb.receivers,
                            edge_attr, jb.edge_mask)
    layer = _port_conv_layer(variables)
    tx = tuple(torch.from_numpy(a) for a in x)
    te = tuple(torch.from_numpy(a) for a in edge_attr)
    args = (tb.senders, tb.receivers, te, tb.edge_mask)
    jargs = (jb.senders, jb.receivers, edge_attr, jb.edge_mask)
    node_mask = rng.random(tb.num_nodes) > 0.5
    auto_x = (x[0] * 2.0, x[1] * 0.5)
    for kwargs, jkwargs in (
            ({}, {}),
            (dict(autoregressive_x=tuple(torch.from_numpy(a) for a in auto_x)),
             dict(autoregressive_x=auto_x)),
            (dict(node_mask=torch.from_numpy(node_mask)),
             dict(node_mask=jnp.asarray(node_mask)))):
        with torch.no_grad():
            got = layer(tx, *args, **kwargs)
        want = jlayer.apply(variables, x, *jargs, **jkwargs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    with torch.no_grad():
        plain = layer(tx, *args)
        auto = layer(tx, *args, autoregressive_x=tx)
        masked = layer(tx, *args, node_mask=torch.from_numpy(node_mask))
    for a, b in zip(auto, plain):          # x as its own decoder input
        torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
    keep = torch.from_numpy(~node_mask)
    assert torch.equal(masked[0][keep], tx[0][keep])
    assert torch.equal(masked[1][keep], tx[1][keep])
    with pytest.raises(ValueError):
        layer(tx, *args, autoregressive_x=tx,
              seg_plans=sss.batch_seg_plans(tb))


@pytest.mark.parametrize("kw", [dict(act_s="swish"), dict(vector_gate=False),
                                dict(aggr="add", act_s="swish")])
def test_general_config_conv_matches_jax(kw):
    """The module-chain route (``gvps[k]``, flax ``gvp_k``), the JAX test's
    configurations."""
    rng = np.random.default_rng(0)
    n, e = 10, 26
    node_dims, edge_dims = (7, 4), (5, 2)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.2
    s = rng.standard_normal((n, 7)).astype(np.float32)
    v = rng.standard_normal((n, 4, 3)).astype(np.float32)
    es = rng.standard_normal((e, 5)).astype(np.float32)
    ev = rng.standard_normal((e, 2, 3)).astype(np.float32)
    jconv = jgvpgnn.GVPConv(node_dims, edge_dims, n_layers=2, **kw)
    variables = jconv.init(jax.random.PRNGKey(0), (s, v), senders, receivers,
                           (es, ev), mask)
    want = jconv.apply(variables, (s, v), senders, receivers, (es, ev), mask)
    conv = gvpgnn.GVPConv(node_dims, edge_dims, n_layers=2, **kw,
                          generator=torch.Generator().manual_seed(0))
    sd = {}
    for key, tree in jax.tree.map(np.asarray, variables)["params"].items():
        _gvp(sd, f"gvps.{key[4:]}", tree)
    conv.load_state_dict(sd, strict=True)
    t = torch.from_numpy
    got = conv((t(s), t(v)), t(senders), t(receivers), (t(es), t(ev)), t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=2e-5)
    with pytest.raises(ValueError):
        conv((t(s), t(v)), t(senders), t(receivers), (t(es), t(ev)), t(mask),
             seg_plans={})


def test_predictor_matches_jax():
    kw = dict(KW, pool="sum")
    graphs = _graphs(num=13, seed=2)
    jmodel = jgvpgnn.GVPGNNModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(0), next(iter(
        jgraph.GraphLoader(graphs, batch_size=5))))
    tmodel = gvpgnn.GVPGNNModel(**kw, use_pallas=True, device="cpu")
    tmodel.load_state_dict(gvp_from_jax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    tmodel.train()               # Predictor serves in eval mode all the same
    y = Predictor(tmodel, batch_size=5, device="cpu").predict(graphs)
    assert tmodel.training
    want = JaxPredictor(jmodel, variables, batch_size=5).predict(graphs)
    assert y.shape == (13, 2)
    np.testing.assert_allclose(y, want, atol=ATOL, rtol=RTOL)


def test_dropout_in_training_is_seeded():
    """Training mode draws the dropout from the model's generator, seeded
    from the weights' generator; eval mode and rate 0 are dropout-free."""
    graphs = _graphs(num=4)
    tb = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 4))
    a, b = (gvpgnn.GVPGNNModel(**KW, device="cpu",
                               generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    with torch.no_grad():
        train_a, train_b = a(tb), b(tb)
        again = a(tb)                     # the generator runs on
        eval_a = a.eval()(tb)
        for m in a.modules():
            if isinstance(m, gvpgnn.gvp.GVPDropout):
                m.rate = 0.0
        quiet = a.train()(tb)
    assert torch.equal(train_a, train_b)
    assert not torch.equal(train_a, again)
    assert not torch.equal(train_a, eval_a)
    assert torch.equal(quiet, eval_a)
    other = gvpgnn.GVPGNNModel(**KW, device="cpu",
                               generator=torch.Generator().manual_seed(6))
    assert other._dropout_rng.seed != a._dropout_rng.seed


def test_bridge_covers_every_parameter_and_init_is_seeded():
    graphs = _graphs(num=4)
    tb = tgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 4))
    for kw in (KW, dict(KW, equivariant_pred=True)):
        jmodel = jgvpgnn.GVPGNNModel(**kw)
        variables = jmodel.init(jax.random.PRNGKey(0), _jax_batch(tb))
        sd = gvp_from_jax(jax.tree.map(np.asarray, variables))
        tmodel = gvpgnn.GVPGNNModel(**kw, device="cpu")
        assert set(sd) == set(tmodel.state_dict())
        for key, value in tmodel.state_dict().items():
            assert sd[key].shape == value.shape, key
    a, b = (gvpgnn.GVPGNNModel(**KW, device="cpu",
                               generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    ws = a.layers[0].conv.gvp0_ws
    bound = 1 / np.sqrt(ws.shape[0])
    assert ws.abs().max() <= bound and ws.abs().max() > 0.9 * bound


def test_routes_that_raise(monkeypatch):
    tb = bench_scale.box_batch(100, sort=True)
    model = gvpgnn.GVPGNNModel(**dict(KW, in_dim=8), use_pallas=True,
                               device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        model(tb, seg_plans=sss.batch_seg_plans(tb))
    with pytest.raises(ValueError):
        gvpgnn.GVPGNNModel(**KW, pool="max", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gvpgnn.GVPGNNModel(**KW)


@pytest.mark.parametrize("layers,remat", [(3, False), (3, True), (4, True)])
def test_gvp_sorted_launches_per_step_counts_the_code(monkeypatch, layers,
                                                       remat):
    """On the CPU the sorted sums and the gather backwards run the plain
    version where the card launches the kernel: count those calls in one
    bench_scale step, as ``chip_smoke.py`` counts the launches on the card."""
    calls = []
    plain = sss.sorted_segment_sum_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(sss, "sorted_segment_sum_plain", counted)
    cfg = dict(num_layers=layers, s_dim=16, v_dim=4, remat=remat)
    tb = bench_scale.box_batch(150, sort=True)
    model = bench_scale.build("gvp_sorted", cfg,
                              torch.Generator().manual_seed(0), "cpu")
    bench_scale.make_step(model, tb, sss.batch_seg_plans(tb))()
    assert len(calls) == bench_scale.sorted_launches_per_step(
        "gvp_sorted", layers, remat) == (3 if remat else 2) * layers


def test_bench_scale_config_rule():
    assert "remat" not in bench_scale.config("gvp_sorted", 10_000)
    assert bench_scale.config("gvp", 30_000)["remat"] is True
    assert bench_scale.config("gvp_sorted", 100_000) == dict(num_layers=4,
                                                             remat=True)
    assert bench_scale.config("egnn_sorted", 100_000) == \
        bench_scale.MODELS["egnn_sorted"]


def test_dropout_follows_the_fit_seed():
    """fit_regression reseeds the model's dropout generator from its seed:
    from the same weights and the same epoch order, two seeds give different
    per-step losses (dropout on) and one seed gives the same losses twice."""
    graphs = _graphs(num=12, seed=5, in_dim=1)
    split = tgraph.random_split(graphs, [0.5, 0.25, 0.25], seed=0)
    pad = tgraph.pad_sizes(graphs, 3)
    loaders = (tgraph.GraphLoader(split[0], 3, shuffle=True, seed=0, pad=pad),
               tgraph.GraphLoader(split[1], 3, pad=pad),
               tgraph.GraphLoader(split[2], 3, pad=pad))
    model = gvpgnn.GVPGNNModel(**dict(KW, in_dim=1, out_dim=1), device="cpu")
    order = torch.arange(len(split[0]))
    runs = {seed: ttrain.fit_regression(
        model, None, *loaders, n_epochs=2, lr=1e-3, seed=seed, device="cpu",
        epoch_order=lambda e: order).train_losses for seed in (0, 1)}
    again = ttrain.fit_regression(model, None, *loaders, n_epochs=2, lr=1e-3,
                                  seed=0, device="cpu",
                                  epoch_order=lambda e: order).train_losses
    assert not np.array_equal(runs[0], runs[1])
    assert np.array_equal(runs[0], again)
    assert runs[0].shape == (2, len(loaders[0]))


def test_drift_trial_runs_one_op_class_in_float32():
    """experiments/trial_gvp_drift: a float64 model with one op class in
    float32 (and a float32 model with one in float64) lies as far from the
    float64 step as float32 rounding, and the modules' own forward comes
    back afterwards."""
    from geometric_message_passing_tpu_torch.experiments import (
        trial_gvp_drift as drift)

    graphs = _graphs(num=6, seed=2, in_dim=1)
    model = gvpgnn.GVPGNNModel(**dict(KW, in_dim=1, out_dim=1), device="cpu")
    row = torch.arange(4)
    exact = drift.one_step(model, graphs, row, "cpu", torch.float64)
    again = drift.one_step(model, graphs, row, "cpu", torch.float64)
    assert drift.grad_error(again, exact)[0] == 0.0
    f32 = drift.grad_error(drift.one_step(model, graphs, row, "cpu",
                                          torch.float32), exact)[0]
    for op_class in drift.CLASSES:
        chosen = drift.select(model, op_class)
        assert chosen and all("forward" not in vars(m) for m in chosen)
        err, _ = drift.grad_error(drift.one_step(
            model, graphs, row, "cpu", torch.float64, op_class), exact)
        assert 0.0 < err < 1e-4, op_class
        err, _ = drift.grad_error(drift.one_step(
            model, graphs, row, "cpu", torch.float32, op_class), exact)
        assert 0.0 < err < 1e-4 and err != f32, op_class
