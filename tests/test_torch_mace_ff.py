"""The port's force fields against the JAX package's: ``MACEForceField``
(both ``RealAgnostic*`` interactions) and ``TFNForceField``, forward and
every parameter's gradient on two 60-atom boxes of 4 species (the JAX
tests' toy sizes: emb 8, max_ell 2, correlation 2), the JAX variables
carried over by ``weights.mace_ff_from_jax`` / ``tfn_ff_from_jax``; the
port's own twins (edge chunks and node blocks that do not divide E and N,
the post-conv linear folded into the chunks) against its single pass;
invariance under O(3); a TFN-FF Adam step; the options that raise;
``bench_scale``'s force-field rows; and ``entry.entry`` against the
repository's ``__graft_entry__.entry``.  On the CPU every K4 call takes its
plain version.

Tolerances: outputs 1e-5 absolute / 1e-4 relative (f32 sums in another
order); gradients 2e-4 of max(|ref|, 1) per parameter, as for MACE."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ortho_group

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models import mace_ff as jmace_ff
from geometric_message_passing_tpu.models import tfn_ff as jtfn_ff
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.entry import ENTRY_MODEL, entry
from geometric_message_passing_tpu_torch.experiments import bench_scale
from geometric_message_passing_tpu_torch.models import (MACEForceField,
                                                        TFNForceField,
                                                        model_registry)
from geometric_message_passing_tpu_torch.nn import conv
from geometric_message_passing_tpu_torch.nn import mace_blocks as mb
from geometric_message_passing_tpu_torch.weights import (mace_ff_from_jax,
                                                         mace_from_jax,
                                                         tfn_ff_from_jax)

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")
MACE_KW = dict(num_layers=2, emb_dim=8, max_ell=2, correlation=2, in_dim=4)
TFN_KW = dict(num_layers=2, emb_dim=8, max_ell=2, in_dim=4)
ROOT = Path(__file__).resolve().parent.parent


def _box(seed=0, n_nodes=60):
    graphs = tds.create_molecular_boxes(num=2, n_nodes=n_nodes, cutoff=3.0,
                                        avg_degree=8, n_species=4, seed=seed)
    return next(iter(tgraph.GraphLoader(graphs, batch_size=2)))


def _jax_batch(tb):
    return jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})


def _bridged(name, kw, tb):
    """JAX model, its variables (numpy leaves) and the port's model with
    them loaded."""
    if name == "mace_ff":
        jmodel = jmace_ff.MACEForceField(**kw)
    else:
        jmodel = jtfn_ff.TFNForceField(**kw)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     _jax_batch(tb)))
    if name == "mace_ff":
        tmodel = MACEForceField(**kw, device="cpu")
        sd = mace_ff_from_jax(variables, tmodel)
    else:
        tmodel = TFNForceField(**kw, device="cpu")
        sd = tfn_ff_from_jax(variables)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, variables, tmodel


def _grads_as_state(name, grads, variables, tmodel):
    if name == "mace_ff":
        return mace_ff_from_jax({"params": grads,
                                 "u_tables": variables["u_tables"]}, tmodel)
    return tfn_ff_from_jax({"params": grads})


@pytest.mark.parametrize("name,kw", [
    ("mace_ff", dict(MACE_KW)),
    ("mace_ff", dict(MACE_KW, interaction="RealAgnosticInteractionBlock",
                     interaction_first="RealAgnosticInteractionBlock")),
    ("tfn_ff", dict(TFN_KW))])
def test_force_field_and_gradients_match_jax(name, kw):
    tb = _box(seed=3)
    jmodel, variables, tmodel = _bridged(name, kw, tb)
    jb = _jax_batch(tb)
    c = np.random.default_rng(1).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)

    def loss(params):
        out = jmodel.apply({**variables, "params": params}, jb)
        return jnp.sum(out * c), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    out = tmodel(tb)
    assert out.shape == (tb.num_graphs, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(c)).sum().backward()
    want_grads = _grads_as_state(name, jax.tree.map(np.asarray, grads),
                                 variables, tmodel)
    assert {n for n, _ in tmodel.named_parameters()} == set(want_grads)
    for pname, p in tmodel.named_parameters():
        ref = want_grads[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=pname, rtol=0,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def _forward_and_grads(model, tb):
    model.zero_grad(set_to_none=True)
    out = model(tb)
    (out ** 2).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _same_run(a, b):
    torch.testing.assert_close(a[0], b[0], atol=ATOL, rtol=RTOL)
    for n, g in a[1].items():
        torch.testing.assert_close(b[1][n], g, atol=ATOL, rtol=RTOL, msg=n)


@pytest.mark.parametrize("cls,kw", [(MACEForceField, MACE_KW),
                                    (TFNForceField, TFN_KW)])
def test_chunked_and_node_blocked_match_one_pass(cls, kw):
    """``edge_chunk`` E // 3 - 1 and ``node_chunk`` N // 2 - 1 (neither
    divides: padded tails) give the single pass's values and gradients."""
    tb = _box(seed=3)
    e, n = tb.num_edges, tb.num_nodes
    one = cls(**kw, node_chunk=None, device="cpu")
    chunked = cls(**kw, edge_chunk=e // 3 - 1, node_chunk=n // 2 - 1,
                  device="cpu")
    assert e % (e // 3 - 1) and n % (n // 2 - 1)
    chunked.load_state_dict(one.state_dict(), strict=True)
    _same_run(_forward_and_grads(one, tb), _forward_and_grads(chunked, tb))


@pytest.mark.parametrize("cls,kw", [(MACEForceField, MACE_KW),
                                    (TFNForceField, TFN_KW)])
def test_folded_linear_matches_unfolded(cls, kw, monkeypatch):
    """The post-conv linear applied to each edge chunk (forced with
    ``FOLD_ACC_ELEMS`` 0, as the JAX test forces it) against the linear of
    the one-pass sum."""
    tb = _box(seed=7)
    one = cls(**kw, device="cpu")
    want = _forward_and_grads(one, tb)
    monkeypatch.setattr(mb._InteractionBase, "FOLD_ACC_ELEMS", 0)
    folded = cls(**kw, edge_chunk=tb.num_edges // 2 - 1, device="cpu")
    folded.load_state_dict(one.state_dict(), strict=True)
    seen = []
    monkeypatch.setattr(mb._InteractionBase, "_chunk",
                        lambda self, *a, _o=mb._InteractionBase._chunk: (
                            seen.append(a[-1]), _o(self, *a))[1])
    _same_run(want, _forward_and_grads(folded, tb))
    assert seen and all(seen)


@pytest.mark.parametrize("cls,kw", [(MACEForceField, MACE_KW),
                                    (TFNForceField, TFN_KW)])
def test_energy_is_invariant_under_o3(cls, kw):
    """In float64, to 1e-6 (the U tables are float32 constants)."""
    graphs = tds.create_molecular_boxes(num=2, n_nodes=60, cutoff=3.0,
                                        avg_degree=8, n_species=4, seed=0)
    model = cls(**kw, edge_chunk=100, device="cpu").double()
    base_batch = next(iter(tgraph.GraphLoader(graphs, batch_size=2)))
    base_batch.pos = base_batch.pos.double()
    with torch.no_grad():
        base = model(base_batch)
        for seed, shift in ((0, 0.73), (1, -0.31)):
            Q = torch.from_numpy(ortho_group.rvs(3, random_state=seed))
            b = next(iter(tgraph.GraphLoader(graphs, batch_size=2)))
            b.pos = base_batch.pos @ Q.T + shift
            torch.testing.assert_close(model(b), base, atol=1e-6, rtol=1e-6)


def test_tfn_ff_adam_step_lowers_the_loss():
    tb = _box(seed=7)
    model = TFNForceField(num_layers=2, emb_dim=8, max_ell=1, in_dim=4,
                          node_chunk=None, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def loss_of():
        out = model(tb)
        return (out - tb.y).abs().sum()

    loss0 = loss_of()
    loss0.backward()
    opt.step()
    with torch.no_grad():
        loss1 = loss_of()
    assert np.isfinite(loss0.item()) and np.isfinite(loss1.item())
    assert loss1.item() < loss0.item()


def test_bad_options_raise():
    model = MACEForceField(**MACE_KW, device="cpu")
    with pytest.raises(ValueError, match="interaction"):
        MACEForceField(**MACE_KW, interaction="AgnosticNonlinearInteractionBlock",
                       device="cpu")
    h = model.hidden_irreps
    with pytest.raises(ValueError, match="needs mesh="):
        conv.EquivariantProductBasisBlock(h, h, 2, tp_axis="tp",
                                          generator=torch.Generator())


def test_registry_and_defaults_follow_jax(monkeypatch):
    assert model_registry["mace_ff"] is MACEForceField
    assert model_registry["tfn_ff"] is TFNForceField
    for cls, jcls in ((MACEForceField, jmace_ff.MACEForceField),
                      (TFNForceField, jtfn_ff.TFNForceField)):
        model = cls(num_layers=1, emb_dim=4, device="cpu")
        j = jcls()
        assert model.r_max == j.r_max and model.max_ell == j.max_ell
        assert model.pool == j.pool
        block = model.interactions[0]
        assert block.node_chunk == j.node_chunk == 16384
        assert block.avg_num_neighbors == j.avg_num_neighbors
        assert block.edge_chunk is j.edge_chunk is None
    mace = MACEForceField(device="cpu")
    assert len(mace.interactions) == 2 and mace.products[0].node_chunk == 16384
    assert repr(mace.hidden_irreps) == "64x0e+64x1o+64x2e+64x3o"
    assert type(mace.interactions[1]).__name__ == jmace_ff.MACEForceField.interaction
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (MACEForceField, TFNForceField):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(num_layers=1, emb_dim=4)


def test_bench_scale_force_field_rows():
    """The JAX script's settings (``scripts/bench_scale.py``: 16384-edge
    chunks below 100k atoms, 8192 from there; a tenth of the steps per
    call, at least 2), the K4 count per step, and one step of each model
    on a small box."""
    for name, width in (("mace_ff", dict(num_layers=2, emb_dim=64, max_ell=3,
                                          correlation=3)),
                        ("tfn_ff", dict(num_layers=4, emb_dim=64,
                                        max_ell=2))):
        assert bench_scale.config(name, 10_000) == dict(width,
                                                         edge_chunk=16384)
        assert bench_scale.config(name, 30_000)["edge_chunk"] == 16384
        assert bench_scale.config(name, 100_000) == dict(width,
                                                          edge_chunk=8192)
        assert bench_scale.model_steps(name, 40) == 4
        assert bench_scale.model_steps(name, 4) == 2
        with pytest.raises(ValueError, match="avg_deg"):
            bench_scale.build(name, dict(num_layers=1, emb_dim=4),
                              torch.Generator(), "cpu")
    assert bench_scale.model_steps("egnn", 40) == 40
    # 10k box: 129,224 edges in 16384-edge chunks
    assert bench_scale.ff_k4_launches_per_step("mace_ff", 2, 8) == 18
    assert bench_scale.ff_k4_launches_per_step("tfn_ff", 4, 8) == 34
    assert bench_scale.ff_k4_launches_per_step("tfn_ff", 4, 1) == 6
    with pytest.raises(ValueError):
        bench_scale.ff_k4_launches_per_step("egnn", 4, 1)
    box = bench_scale.box_batch(150, sort=False)
    deg = bench_scale.mean_degree(box)
    assert deg == int(box.edge_mask.sum()) / int(box.node_mask.sum())
    for name, cfg in (("mace_ff", dict(num_layers=1, emb_dim=4, max_ell=2,
                                       correlation=2, edge_chunk=500,
                                       node_chunk=64)),
                      ("tfn_ff", dict(num_layers=2, emb_dim=4, max_ell=1,
                                      edge_chunk=500))):
        model = bench_scale.build(name, cfg, torch.Generator().manual_seed(0),
                                  "cpu", avg_deg=deg)
        assert model.interactions[0].avg_num_neighbors == deg
        assert bench_scale.edge_chunks(cfg, box) == -(-box.num_edges // 500)
        loss = bench_scale.make_step(model, box)()
        assert np.isfinite(loss.item())


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_matches_the_jax_entry(monkeypatch):
    jfn, (variables, jbatch) = _graft_entry().entry()
    fn, (model, batch) = entry(device="cpu")
    assert not model.training
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(batch, key).numpy(),
                                      np.asarray(getattr(jbatch, key)))
    want = np.asarray(jfn(variables, jbatch))
    model.load_state_dict(mace_from_jax(jax.tree.map(np.asarray, variables),
                                        model), strict=True)
    got = fn(model, batch).detach().numpy()
    assert got.shape == want.shape == (batch.num_graphs, ENTRY_MODEL["out_dim"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_predictor_serves_chunked_force_fields():
    """``Predictor`` (eval, inference mode) over chunked and node-blocked
    force fields gives the single pass's energies."""
    from geometric_message_passing_tpu_torch.experiments.infer import Predictor

    graphs = tds.create_molecular_boxes(num=3, n_nodes=80, cutoff=3.0,
                                        avg_degree=8, n_species=4, seed=2)
    for cls, kw in ((MACEForceField, MACE_KW), (TFNForceField, TFN_KW)):
        one = cls(**kw, device="cpu")
        chunked = cls(**kw, edge_chunk=200, node_chunk=50, device="cpu")
        chunked.load_state_dict(one.state_dict(), strict=True)
        want = Predictor(one, batch_size=2, device="cpu").predict(graphs)
        got = Predictor(chunked, batch_size=2, device="cpu").predict(graphs)
        assert got.shape == (3, 1) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        # the products' constants, first made under inference mode, still
        # serve a training step afterwards
        loss = bench_scale.make_step(chunked, _box(seed=2, n_nodes=80))()
        assert np.isfinite(loss.item())
