"""The port's MACE stack against the JAX package's: the U matrices
(``irreps.u_matrix_real``), ``Contraction`` and ``SymmetricContraction``
(the fused chain against the descending-nu chain, and both against JAX),
``IrrepsLinear``, ``reshape_irreps`` / ``inverse_reshape_irreps``,
``EquivariantProductBasisBlock`` and ``MACEModel`` (forward, every
parameter's gradient, the batch-norm running statistics after a train
step, invariance under rotations), with the JAX variables carried over by
``weights.mace_from_jax``.  On the CPU every K7 and K4 call takes its plain
version.

Tolerances: U matrices 1e-6; module outputs 1e-5 absolute / 1e-4 relative
(f32 products in another order); gradients 2e-4 of max(|ref|, 1) per
parameter, as for TFN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import irreps as jirreps
from geometric_message_passing_tpu.models import mace as jmace
from geometric_message_passing_tpu.nn import conv as jconv
from geometric_message_passing_tpu.nn import equivariant as jeq
from geometric_message_passing_tpu.nn import symmetric_contraction as jsc
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch import irreps
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models import mace, model_registry
from geometric_message_passing_tpu_torch.nn import conv, equivariant as eq
from geometric_message_passing_tpu_torch.nn import symmetric_contraction as sc
from geometric_message_passing_tpu_torch.weights import mace_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")
KW = dict(num_layers=2, emb_dim=8, max_ell=2, mlp_dim=16, in_dim=2,
          out_dim=1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _load(module, tree, prefix=""):
    """Copy a flax parameter tree (numpy leaves) into ``module`` by name."""
    sd = {f"{prefix}{k}": torch.from_numpy(np.array(v, np.float32))
          for k, v in tree.items()}
    module.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("nu", [1, 2, 3])
def test_u_matrices_match_jax(nu):
    for lmax in (1, 2, 3):
        coupling = irreps.Irreps.spherical_harmonics(lmax)
        for l in range(4):
            for p in (1, -1):
                got = irreps.u_matrix_real(coupling, irreps.Irrep(l, p), nu)
                want = jirreps.u_matrix_real(jirreps.Irreps(str(coupling)),
                                             jirreps.Irrep(l, p), nu)
                assert got.shape == want.shape
                if got.size:
                    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_u_matrix_disk_cache_round_trips(tmp_path, monkeypatch):
    monkeypatch.setattr(irreps, "_DISK_CACHE_DIR", None)
    irreps.set_disk_cache(str(tmp_path / "u"))
    irreps._u_matrix_cached.cache_clear()
    try:
        args = (irreps.Irreps("1x0e+1x1o"), irreps.Irrep(1, -1), 2)
        first = irreps.u_matrix_real(*args)
        files = list((tmp_path / "u").glob("*.npy"))
        assert len(files) == 1
        irreps._u_matrix_cached.cache_clear()
        np.testing.assert_array_equal(irreps.u_matrix_real(*args), first)
    finally:
        irreps._u_matrix_cached.cache_clear()


def _jax_sc(hidden, correlation, x, fused=True):
    module = jsc.SymmetricContraction(
        irreps_in=jirreps.Irreps(hidden), irreps_out=jirreps.Irreps(hidden),
        correlation=correlation, fused_lowrank=fused)
    v = module.init(jax.random.PRNGKey(correlation), jnp.asarray(x))
    return np.asarray(module.apply(v, jnp.asarray(x))), v


@pytest.mark.parametrize("hidden,correlation", [
    ("4x0e+4x1o+4x2e", 1), ("4x0e+4x1o+4x2e", 2), ("4x0e+4x1o+4x2e", 3),
    ("3x0e+3x0o+3x1o", 3), ("3x0e+3x1o", 4)])
def test_symmetric_contraction_paths_match_each_other_and_jax(hidden,
                                                              correlation):
    h = irreps.Irreps(hidden)
    x = _x((7, h[0][0], sum(ir.dim for _, ir in h)), correlation)
    want, v = _jax_sc(hidden, correlation, x)
    outs = {}
    for fused in (True, False):
        module = sc.SymmetricContraction(h, h, correlation,
                                         fused_lowrank=fused, generator=_gen())
        assert module.fused == (fused and correlation <= 3)
        _load(module, v["params"])
        for nu in range(1, correlation + 1):       # the JAX U tables
            np.testing.assert_allclose(getattr(module, f"u{nu}").numpy(),
                                       v["u_tables"][f"u{nu}"], atol=1e-6)
        outs[fused] = module(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(outs[fused], want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(outs[True], outs[False], atol=ATOL, rtol=RTOL)
    if correlation <= 3:     # JAX's own chain agrees too
        np.testing.assert_allclose(_jax_sc(hidden, correlation, x, False)[0],
                                   want, atol=ATOL, rtol=RTOL)


def test_symmetric_contraction_state_holds_no_u_tables():
    h = irreps.Irreps("2x0e+2x1o")
    module = sc.SymmetricContraction(h, h, 3, generator=_gen())
    assert not any(k.startswith("u") for k in module.state_dict())
    assert [n for n, _ in module.named_parameters()] == [
        f"contraction_{ir}_w{nu}" for nu in (1, 2, 3) for ir in ("0e", "1o")]
    # chain_dtype (ported): the same state, the chain in bf16, f32 out
    low = sc.SymmetricContraction(h, h, 3, chain_dtype="bfloat16",
                                  generator=_gen())
    assert list(low.state_dict()) == list(module.state_dict())
    x = torch.from_numpy(_x((4, 2, 4), 3))
    out = low(x)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, module(x), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("element_dependent", [False, True])
def test_contraction_matches_jax(element_dependent):
    coupling = "1x0e+1x1o+1x2e"
    x = _x((5, 3, 9), 4)
    y = np.eye(2, dtype=np.float32)[np.array([0, 1, 1, 0, 1])]
    kw = dict(correlation=3, num_features=3,
              element_dependent=element_dependent, num_elements=2)
    jm = jsc.Contraction(irreps_in=jirreps.Irreps(coupling),
                         ir_out=jirreps.Irrep(1, -1), **kw)
    v = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(y))
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(y)))
    tm = sc.Contraction(irreps.Irreps(coupling), irreps.Irrep(1, -1),
                        generator=_gen(), **kw)
    _load(tm, v["params"])
    got = tm(torch.from_numpy(x), torch.from_numpy(y)).detach().numpy()
    assert got.shape == (5, 3 * 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ins,outs", [
    ("4x0e+4x1o+4x2e", "4x0e+4x1o+4x2e"),       # MACE's square map
    ("3x0e+2x1o+5x0e", "4x0e+3x1o+2x2e")])       # the general path
def test_irreps_linear_and_reshape_match_jax(ins, outs):
    x = _x((6, irreps.Irreps(ins).dim), 6)
    jm = jeq.IrrepsLinear(jirreps.Irreps(ins), jirreps.Irreps(outs))
    v = jm.init(jax.random.PRNGKey(6), jnp.asarray(x))
    tm = eq.IrrepsLinear(irreps.Irreps(ins), irreps.Irreps(outs),
                         generator=_gen())
    assert {n for n, _ in tm.named_parameters()} == set(v["params"])
    _load(tm, v["params"])
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(x))),
                               atol=ATOL, rtol=RTOL)
    if ins == outs:
        h = irreps.Irreps(ins)
        r = eq.reshape_irreps(torch.from_numpy(x), h)
        np.testing.assert_array_equal(
            r.numpy(), np.asarray(jeq.reshape_irreps(jnp.asarray(x),
                                                     jirreps.Irreps(ins))))
        np.testing.assert_array_equal(eq.inverse_reshape_irreps(r, h).numpy(), x)
    else:
        with pytest.raises(ValueError, match="one multiplicity"):
            eq.reshape_irreps(torch.from_numpy(x), irreps.Irreps(ins))


def test_product_basis_block_matches_jax():
    hidden = "4x0e+4x1o+4x2e"
    h = irreps.Irreps(hidden)
    x = _x((6, 4, 9), 7)
    skip = _x((6, h.dim), 8)
    jm = jconv.EquivariantProductBasisBlock(
        node_feats_irreps=jirreps.Irreps(hidden),
        target_irreps=jirreps.Irreps(hidden), correlation=3)
    v = jm.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(skip))
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(skip)))
    tm = conv.EquivariantProductBasisBlock(h, h, 3, generator=_gen())
    p = v["params"]
    sd = {f"linear.{k}": np.asarray(a) for k, a in p["IrrepsLinear_0"].items()}
    sd.update({f"symmetric_contraction.{k}": np.asarray(a)
               for k, a in p["SymmetricContraction_0"].items()})
    _load(tm, sd)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x), torch.from_numpy(skip)).detach().numpy(),
        want, atol=ATOL, rtol=RTOL)
    # node blocks of 4 over the 6 nodes (box scale) give the same values
    blocked = conv.EquivariantProductBasisBlock(h, h, 3, node_chunk=4,
                                                generator=_gen())
    _load(blocked, sd)
    np.testing.assert_allclose(
        blocked(torch.from_numpy(x), torch.from_numpy(skip)).detach().numpy(),
        want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="needs mesh="):
        conv.EquivariantProductBasisBlock(h, h, 3, generator=_gen(),
                                          tp_axis="tp")


def _graphs(num=4, seed=0, in_dim=2):
    graphs = tds.create_star_graphs(num=num, fold=(4, 5, 6), seed=seed)
    rng = np.random.default_rng(seed)
    for g in graphs:
        g.atoms = rng.integers(0, in_dim, g.num_nodes).astype(np.int32)
    return graphs


def _jax_batch(tb):
    return jgraph.GraphBatch(triplets=None, **{
        k: jnp.asarray(getattr(tb, k).numpy()) for k in FIELDS})


def _bridged(kw, tb, seed=0):
    jmodel = jmace.MACEModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(seed), _jax_batch(tb))
    tmodel = mace.MACEModel(**kw, device="cpu")
    tmodel.load_state_dict(
        mace_from_jax(jax.tree.map(np.asarray, variables), tmodel), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("variant", [
    dict(correlation=3), dict(correlation=2, pool="first"),
    dict(correlation=3, equivariant_pred=True, out_dim=2),
    dict(correlation=2, pool="first", equivariant_pred=True),
    dict(correlation=3, hidden_irreps="8x0e+8x0o+8x1o+8x2e")])
def test_model_and_gradients_match_jax(variant):
    kw = dict(KW, **variant)
    graphs = _graphs()
    tb = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 5))
    jmodel, variables, tmodel = _bridged(kw, tb)
    jb = _jax_batch(tb)
    c = _x((tb.num_graphs, kw["out_dim"]), 1)

    def loss(params):
        out, _ = jmodel.apply({**variables, "params": params}, jb, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out * c), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    tmodel.eval()              # before a train pass moves the statistics
    np.testing.assert_allclose(tmodel(tb).detach().numpy(),
                               np.asarray(jmodel.apply(variables, jb)),
                               atol=ATOL, rtol=RTOL)
    tmodel.train()
    out = tmodel(tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (out * torch.from_numpy(c)).sum().backward()
    want_grads = mace_from_jax({"params": jax.tree.map(np.asarray, grads),
                                "u_tables": variables["u_tables"]}, tmodel)
    assert {n for n, _ in tmodel.named_parameters()} == set(want_grads)
    for name, p in tmodel.named_parameters():
        ref = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name, rtol=0,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_batch_norm_statistics_after_a_train_step_match_jax():
    kw = dict(KW, correlation=3)
    graphs = _graphs(num=5, seed=3)
    slot = tgraph.build_slot_data(graphs)
    row = torch.tensor([3, 0, 4, 5])            # one sentinel slot
    tb = tgraph.assemble_batch(slot, row)
    jmodel, variables, tmodel = _bridged(kw, tb, seed=2)
    _, mutated = jmodel.apply(variables, _jax_batch(tb), train=True,
                              mutable=["batch_stats"])
    tmodel.train()
    loss = ttrain.train_step(tmodel, ttrain.make_tx(tmodel.parameters(), 1e-3),
                             slot, row)
    assert np.isfinite(loss.item())
    want = mace_from_jax({"params": jax.tree.map(np.asarray,
                                                 variables["params"]),
                          "batch_stats": jax.tree.map(np.asarray, mutated[
                              "batch_stats"]),
                          "u_tables": variables["u_tables"]}, tmodel)
    buffers = dict(tmodel.named_buffers())
    stats = [k for k in want if k in buffers]
    assert len(stats) == 2 * 4                   # mean0 + var0..2, per layer
    for key in stats:
        np.testing.assert_allclose(buffers[key].numpy(), want[key].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=key)


def test_scalar_output_is_invariant_under_rotations():
    """In float64, to 1e-6: the U tables are float32 constants (as in the
    JAX package), whose rounding bends equivariance at ~1e-8 relative."""
    graphs = _graphs(num=3, seed=4)
    model = mace.MACEModel(**dict(KW, correlation=3), device="cpu",
                           generator=_gen(3)).double().eval()
    tb = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 3))
    tb.pos = tb.pos.double()
    rng = np.random.default_rng(9)
    with torch.no_grad():
        base = model(tb)
        for _ in range(2):
            R = torch.from_numpy(tds.rand_rotation(rng))
            tb2 = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 3))
            tb2.pos = tb.pos @ R.T
            torch.testing.assert_close(model(tb2), base, atol=1e-6, rtol=1e-6)


def test_mace_from_jax_rejects_other_u_tables():
    graphs = _graphs(num=2)
    tb = tgraph.batch_graphs(graphs, *tgraph.pad_sizes(graphs, 2))
    kw = dict(KW, correlation=2)
    jmodel = jmace.MACEModel(**kw)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     _jax_batch(tb)))
    other = mace.MACEModel(**dict(kw, max_ell=1), device="cpu")
    with pytest.raises(ValueError, match="U table"):
        mace_from_jax(variables, other)


def test_registry_defaults_and_unported_options(monkeypatch):
    assert model_registry["mace"] is mace.MACEModel
    model = mace.MACEModel(device="cpu")
    jmodel = jmace.MACEModel()
    assert (model.max_ell, model.correlation, len(model.convs), model.emb_dim,
            model.pool) == (jmodel.max_ell, jmodel.correlation,
                            jmodel.num_layers, jmodel.emb_dim, jmodel.pool)
    assert repr(model.hidden_irreps) == "64x0e+64x1o+64x2e"
    assert model.convs[0].gate is None and model.convs[0].bn is not None
    with pytest.raises(ValueError, match="needs mesh="):
        mace.MACEModel(tp_axis="tp", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mace.MACEModel()
