"""The port's precision policy (``precision.py``) against numpy float64 and
the JAX package's scopes: the ``bfloat16_3x`` product and its backward
held to the float64 value of their three-term formula (f32 accumulation:
K * 2^-23 of ``|A| @ |B|``) and to the float64 product (the dropped terms:
2^-15 more); a ``highest`` site under a lowered process default is the
plain torch call, bitwise; the process default set and restored; each
``tp_precision_scope`` sends exactly the JAX scope's products of MACE (and
TFN's, MACE-FF's) to the process default, read with ``precision.record``;
``SymmetricContraction(chain_dtype="bfloat16")`` against JAX's at a bf16
tolerance (3e-2 of max(|ref|, 1)).  TF32 acts on the card only
(``chip_smoke.py`` phase 11a)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import irreps as jirreps
from geometric_message_passing_tpu.models import mace as jmace
from geometric_message_passing_tpu.nn import symmetric_contraction as jsc
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch import irreps
from geometric_message_passing_tpu_torch import precision as prec
from geometric_message_passing_tpu_torch.models import (MACEForceField,
                                                         MACEModel, TFNModel)
from geometric_message_passing_tpu_torch.nn import symmetric_contraction as sc

F64 = torch.float64


def _mats(seed=0, m=33, k=96, n=20):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=g), torch.randn(k, n, generator=g),
            torch.randn(m, n, generator=g))


def _three_terms64(a, b):
    """hi.hi + hi.lo + lo.hi of the bf16 splits, in float64."""
    (ah, al), (bh, bl) = prec.split_bf16(a), prec.split_bf16(b)
    ah, al, bh, bl = (t.to(F64) for t in (ah, al, bh, bl))
    return ah @ bh + ah @ bl + al @ bh


def test_bfloat16_3x_product_against_float64():
    a, b, g = _mats()
    k = a.shape[1]
    scale = a.abs().to(F64) @ b.abs().to(F64)
    out = prec.matmul(a, b, "bfloat16_3x")
    assert out.dtype == torch.float32
    acc = (out.to(F64) - _three_terms64(a, b)).abs()
    assert bool((acc <= k * 2.0 ** -23 * scale).all())
    err = (out.to(F64) - a.to(F64) @ b.to(F64)).abs()
    assert bool((err <= (2.0 ** -15 + k * 2.0 ** -23) * scale).all())
    exact = ((a @ b).to(F64) - a.to(F64) @ b.to(F64)).abs()
    assert err.max() > exact.max()             # not the f32 product
    # the backward's transposed products in bfloat16_3x too
    a.requires_grad_(True)
    b.requires_grad_(True)
    (prec.matmul(a, b, "bfloat16_3x") * g).sum().backward()
    gh, gl = prec.split_bf16(g)
    (ah, al), (bh, bl) = prec.split_bf16(a.detach()), prec.split_bf16(b.detach())
    want_a = sum(x.to(F64) @ y.to(F64).T
                 for x, y in ((gh, bh), (gl, bh), (gh, bl)))
    want_b = sum(x.to(F64).T @ y.to(F64)
                 for x, y in ((ah, gh), (ah, gl), (al, gh)))
    for got, want, kk in ((a.grad, want_a, g.shape[1]),
                          (b.grad, want_b, g.shape[0])):
        assert bool(((got.to(F64) - want).abs()
                     <= kk * 2.0 ** -23 * want.abs().max()).all())


def test_bfloat16_3x_einsum_of_three_operands():
    """More than two operands: the terms with at most one ``lo``, exact."""
    g = torch.Generator().manual_seed(1)
    u, w, x = (torch.randn(*s, generator=g) for s in ((5, 7), (7, 3), (4, 3, 5)))
    out = prec.einsum("ik,kc,bci->bc", u, w, x, precision="bfloat16_3x")
    parts = [prec.split_bf16(t) for t in (u, w, x)]
    his = [p[0].to(F64) for p in parts]
    want = torch.einsum("ik,kc,bci->bc", *his)
    for j in range(3):
        ops = list(his)
        ops[j] = parts[j][1].to(F64)
        want = want + torch.einsum("ik,kc,bci->bc", *ops)
    torch.testing.assert_close(out.to(F64), want, atol=1e-6, rtol=1e-6)


def test_sites_under_a_lowered_process_default():
    a, b, _ = _mats(2)
    with prec.matmul_precision("bfloat16_3x") as name:
        assert name == prec.process_default() == "bfloat16_3x"
        assert torch.equal(prec.matmul(a, b, "highest"), a @ b)
        assert torch.equal(prec.matmul(a, b, "float32"), a @ b)
        assert torch.equal(prec.matmul(a, b),
                           prec.matmul(a, b, "bfloat16_3x"))
        assert torch.equal(prec.matmul(a, b, "default"), prec.matmul(a, b))
        bias = torch.randn(b.shape[1])
        torch.testing.assert_close(prec.addmm(bias, a, b),
                                   prec.matmul(a, b) + bias, atol=0, rtol=0)
    assert prec.process_default() == "highest"
    # bf16 and float64 operands: the plain call whatever the precision
    with prec.matmul_precision("bfloat16_3x"):
        a16 = a.to(torch.bfloat16)
        assert torch.equal(prec.matmul(a16, b.to(torch.bfloat16)),
                           a16 @ b.to(torch.bfloat16))
        assert torch.equal(prec.matmul(a.double(), b.double()),
                           a.double() @ b.double())


def test_process_default_restored_and_flags_checked():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        with prec.matmul_precision("tensorfloat32"):
            assert torch.backends.cuda.matmul.allow_tf32 is True
            prec.check_flags()
            with prec.matmul_precision("default"):
                assert prec.process_default() == "highest"
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert prec.process_default() == "tensorfloat32"
            torch.backends.cuda.matmul.allow_tf32 = False
            with pytest.raises(ValueError, match="allow_tf32"):
                prec.check_flags()
        assert torch.backends.cuda.matmul.allow_tf32 is saved
        with pytest.raises(ValueError, match="precision must be"):
            prec.canonical("bfloat16_6x")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_scoped_function_is_the_plain_product():
    """The card's scoped path (flag set in forward and backward) computes
    the plain product and its gradients; on the CPU the flag changes
    nothing, so bitwise."""
    a, b, g = _mats(3)
    ref = [t.clone().requires_grad_(True) for t in (a, b)]
    (torch.matmul(*ref) * g).sum().backward()
    got = [t.clone().requires_grad_(True) for t in (a, b)]
    out = prec._Scoped.apply(torch.matmul, True, *got)
    (out * g).sum().backward()
    assert torch.equal(out, torch.matmul(a, b))
    for x, y in zip(got, ref):
        assert torch.equal(x.grad, y.grad)


def _batch(in_dim=2, num=3):
    graphs = tds.create_star_graphs(num=num, fold=(4, 5), seed=0)
    rng = np.random.default_rng(0)
    for gr in graphs:
        gr.atoms = rng.integers(0, in_dim, gr.num_nodes).astype(np.int32)
    return next(iter(tgraph.GraphLoader(graphs, batch_size=num)))


def _sites(model, batch):
    with prec.record() as seen:
        model(batch)
    out = {}
    for site, p in seen:
        out.setdefault(site, set()).add(p)
    return out


MACE_KW = dict(num_layers=1, emb_dim=4, max_ell=1, correlation=2,
               mlp_dim=8, in_dim=2, out_dim=1)


@pytest.mark.parametrize("tp_precision", ["highest", None])
@pytest.mark.parametrize("scope", ["all", "conv", "prod", "heads"])
def test_mace_scopes_match_jax(scope, tp_precision):
    jm = jmace.MACEModel(**MACE_KW, tp_precision=tp_precision,
                         tp_precision_scope=scope)
    stage = {s: jm._scoped_precision(s) for s in ("conv", "prod", "heads")}
    model = MACEModel(**MACE_KW, tp_precision=tp_precision,
                      tp_precision_scope=scope, device="cpu")
    assert {s: model._scoped_precision(s) for s in stage} == stage
    assert _sites(model, _batch()) == {
        "tp": {stage["conv"]}, "heads": {stage["heads"]},
        "chain": {stage["prod"]}, "prod_linear": {stage["prod"]},
        "dense": {None}}
    with pytest.raises(ValueError, match="tp_precision_scope"):
        MACEModel(**MACE_KW, tp_precision_scope="edges", device="cpu")


def test_tfn_and_mace_ff_scopes_match_jax():
    """TFN: the edge products at ``tp_precision`` (heads and trunk at the
    process default); MACE-FF: the 'uvu' products, the post-convolution
    linear and the product blocks at it, everything else the default."""
    tfn = TFNModel(num_layers=1, emb_dim=4, max_ell=1, mlp_dim=8, in_dim=2,
                   tp_precision="highest", device="cpu")
    assert _sites(tfn, _batch()) == {"tp": {"highest"}, "heads": {None},
                                     "dense": {None}}
    ff = MACEForceField(num_layers=1, emb_dim=4, max_ell=1, correlation=2,
                        in_dim=2, tp_precision="highest", device="cpu")
    sites = _sites(ff, _batch())
    for site in ("tp", "conv_linear", "chain", "prod_linear"):
        assert sites.pop(site) == {"highest"}, site
    assert sites and all(v == {None} for v in sites.values()), sites
    assert "irreps_linear" in sites and "radial" in sites
    # the defaults the models take these from are JAX's
    from geometric_message_passing_tpu.models import (mace_ff as jff,
                                                      tfn as jtfn,
                                                      tfn_ff as jtff)
    from geometric_message_passing_tpu_torch.models import TFNForceField
    import inspect
    for port, jax_cls in ((TFNModel, jtfn.TFNModel),
                          (MACEForceField, jff.MACEForceField),
                          (TFNForceField, jtff.TFNForceField),
                          (MACEModel, jmace.MACEModel)):
        default = inspect.signature(port).parameters["tp_precision"].default
        assert default == jax_cls.tp_precision, port


@pytest.mark.parametrize("fused", [True, False])
def test_chain_dtype_bfloat16_matches_jax(fused):
    hidden = "4x0e+4x1o+4x2e"
    h = irreps.Irreps(hidden)
    x = np.random.default_rng(0).normal(size=(6, 4, 9)).astype(np.float32)
    jm = jsc.SymmetricContraction(
        irreps_in=jirreps.Irreps(hidden), irreps_out=jirreps.Irreps(hidden),
        correlation=3, fused_lowrank=fused, chain_dtype="bfloat16")
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)), np.float32)
    module = sc.SymmetricContraction(h, h, 3, fused_lowrank=fused,
                                     chain_dtype="bfloat16",
                                     generator=torch.Generator())
    module.load_state_dict({k: torch.from_numpy(np.array(w, np.float32))
                            for k, w in v["params"].items()}, strict=True)
    got = module(torch.from_numpy(x))
    assert got.dtype == torch.float32
    tol = 3e-2 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)
    module.chain_dtype = None                   # the f32 chain differs
    exact = module(torch.from_numpy(x)).detach().numpy()
    assert np.abs(exact - got.detach().numpy()).max() > 1e-4


def test_mace_step_in_bfloat16_3x_tracks_float64():
    """One train step of a small MACE on the CPU with every product in
    ``bfloat16_3x`` (the process default and the model's own scope): the
    gradients within 1e-3 of each tensor's largest float64 entry, farther
    than the exact f32 step's."""
    batch = _batch()

    def grads(dtype, name, tp_precision):
        model = MACEModel(**MACE_KW, tp_precision=tp_precision,
                          device="cpu").to(dtype)
        b = tgraph.GraphBatch(**{
            k: (getattr(batch, k).to(dtype) if k in ("pos", "y")
                else getattr(batch, k)) for k in (
                "atoms", "pos", "senders", "receivers", "graph_id", "y",
                "node_mask", "edge_mask", "graph_mask", "first_node")})
        with prec.matmul_precision(name):
            model(b).sum().backward()
        return {n: p.grad.to(F64) for n, p in model.named_parameters()}

    ref = grads(F64, None, "highest")
    f32 = grads(torch.float32, None, "highest")
    low = grads(torch.float32, "bfloat16_3x", None)

    def err(got):
        return max(((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30)
                    ).item() for n, r in ref.items())

    assert err(low) < 1e-3
    assert err(low) > err(f32)


def test_seed_spread_chain_dtype_arm():
    """``seed_spread --chain-dtype``: every symmetric contraction of the
    built MACE in bf16; a model without one refuses."""
    from geometric_message_passing_tpu_torch.experiments import seed_spread

    build = seed_spread.with_chain_dtype(MACEModel, "bfloat16")
    model = build(**dict(MACE_KW, num_layers=2), device="cpu")
    found = [m.chain_dtype for m in model.modules()
             if isinstance(m, sc.SymmetricContraction)]
    assert found == ["bfloat16", "bfloat16"]
    with pytest.raises(ValueError, match="symmetric contraction"):
        seed_spread.with_chain_dtype(TFNModel, "bfloat16")(
            num_layers=1, emb_dim=4, max_ell=1, mlp_dim=8, device="cpu")
