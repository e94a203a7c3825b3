"""K7's plain versions (``ops/edge_contract.py``) against the JAX package's
Pallas kernel run by the Mosaic interpreter (``edge_weighted_contract(...,
force="interpret")``) and its einsum twin, at the shapes of
``tests/test_pallas.py``: forward and both gradients through the autograd
function, including bf16 W (its cotangent keeps bf16) and a ragged E; the
grouped entry (``edge_weighted_contract_grouped``) group by group over mixed
m, and ``EdgeTensorProduct`` through it against the JAX layer; the grouped
launch's work list (``contract_plan``).  Tolerances are the JAX test's:
2e-5 for f32 W, 3e-2 for bf16, the gradients scaled by max(|ref|, 1).  On
the CPU no kernel launches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import irreps as jir
from geometric_message_passing_tpu.nn import tensor_product as jtp
from geometric_message_passing_tpu.ops import pallas_tp
from geometric_message_passing_tpu_torch import irreps as tir
from geometric_message_passing_tpu_torch.nn import tensor_product as ttp
from geometric_message_passing_tpu_torch.ops import edge_contract as ec

SHAPES = [(70, 96, 16, 7, "float32"), (64, 32, 8, 1, "float32"),
          (33, 64, 16, 5, "bfloat16")]


def _inputs(E, K, w, m, wdtype, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((E, K, m)).astype(np.float32)
    W = rng.standard_normal((E, K, w)).astype(np.float32)
    jW = jnp.asarray(W, getattr(jnp, wdtype))
    tW = torch.from_numpy(W).to(getattr(torch, wdtype))
    return T, jW, tW


@pytest.mark.parametrize("E,K,w,m,wdtype", SHAPES)
def test_plain_matches_the_interpreted_pallas_kernel(E, K, w, m, wdtype):
    T, jW, tW = _inputs(E, K, w, m, wdtype)
    tol = 2e-5 if wdtype == "float32" else 3e-2
    jT = jnp.asarray(T)
    want = np.asarray(pallas_tp.edge_weighted_contract(jT, jW, te=32,
                                                       force="interpret"))
    Tt = torch.from_numpy(T).requires_grad_(True)
    Wt = tW.clone().requires_grad_(True)
    before = (ec.edge_weighted_contract.launches,
              ec.edge_weighted_contract.bwd_launches)
    out = ec.edge_weighted_contract(Tt, Wt)
    assert out.dtype == torch.float32 and out.shape == (E, w, m)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=tol)

    def loss(T_, W_):
        return jnp.sum(jnp.square(pallas_tp.edge_weighted_contract(
            T_, W_, te=32, force="interpret")))

    gT, gW = jax.grad(loss, argnums=(0, 1))(jT, jW)
    (out**2).sum().backward()
    assert Wt.grad.dtype == Wt.dtype
    for got, ref in ((Tt.grad, gT), (Wt.grad, gW)):
        ref = np.asarray(ref.astype(jnp.float32))
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol * scale)
    assert (ec.edge_weighted_contract.launches,
            ec.edge_weighted_contract.bwd_launches) == before


@pytest.mark.parametrize("E,K,w,m,wdtype", SHAPES)
def test_plain_versions_match_the_einsum_twin(E, K, w, m, wdtype):
    T, jW, tW = _inputs(E, K, w, m, wdtype, seed=1)
    np.testing.assert_allclose(
        ec.edge_weighted_contract_plain(torch.from_numpy(T), tW).numpy(),
        np.asarray(pallas_tp._contract_xla(jnp.asarray(T), jW)),
        atol=2e-5 if wdtype == "float32" else 3e-2)
    dO = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (E, w, m)).astype(np.float32))
    dT, dW = ec.edge_weighted_contract_bwd(torch.from_numpy(T), tW, dO)
    _, vjp = jax.vjp(pallas_tp._contract_xla, jnp.asarray(T), jW)
    jdT, jdW = vjp(jnp.asarray(dO.numpy()))
    assert dW.dtype == tW.dtype and dT.dtype == torch.float32
    np.testing.assert_allclose(dT.numpy(), np.asarray(jdT), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(dW.float().numpy(),
                               np.asarray(jdW.astype(jnp.float32)),
                               atol=1e-4 if wdtype == "float32" else 0.1,
                               rtol=1e-5 if wdtype == "float32" else 1e-2)


def test_float64_autograd_is_exact():
    rng = np.random.default_rng(3)
    T = torch.from_numpy(rng.standard_normal((5, 12, 3))).requires_grad_(True)
    W = torch.from_numpy(rng.standard_normal((5, 12, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(ec.edge_weighted_contract, (T, W))


def test_card_inputs_are_checked():
    T = torch.zeros((4, 6, 4))
    W = torch.zeros((4, 6, 3))
    with pytest.raises(ValueError, match="odd"):
        ec._check(T, W)
    with pytest.raises(ValueError, match="float32"):
        ec._check(T.double()[..., :3], W)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ec._check(T[..., :3], W.half())
    with pytest.raises(ValueError, match="do not match"):
        ec._check(T[..., :3], W[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        ec.edge_weighted_contract(T[..., :3].to("meta"), W.to("meta"))


# (E, groups (K, m, w), W type): one grouped call over mixed m
GROUPED = [(37, [(96, 1, 16), (40, 3, 8), (64, 5, 16), (32, 7, 8)], "float32"),
           (33, [(64, 1, 16), (32, 3, 16), (48, 5, 8), (16, 7, 16)],
            "bfloat16")]


@pytest.mark.parametrize("E,groups,wdtype", GROUPED)
def test_grouped_matches_the_pallas_kernel_group_by_group(E, groups, wdtype):
    """The grouped entry's CPU path against the interpreted Pallas kernel and
    the einsum twin, each group on its own, forward and both gradients of a
    loss over all groups."""
    rng = np.random.default_rng(4)
    tol = 2e-5 if wdtype == "float32" else 3e-2
    Tn = [rng.standard_normal((E, k, m)).astype(np.float32)
          for k, m, _ in groups]
    Wn = [rng.standard_normal((E, k, w)).astype(np.float32)
          for k, _, w in groups]
    cots = [rng.standard_normal((E, w, m)).astype(np.float32)
            for _, m, w in groups]
    jT = [jnp.asarray(t) for t in Tn]
    jW = [jnp.asarray(w, getattr(jnp, wdtype)) for w in Wn]
    Tt = [torch.from_numpy(t).requires_grad_(True) for t in Tn]
    Wt = [torch.from_numpy(w).to(getattr(torch, wdtype)).requires_grad_(True)
          for w in Wn]
    before = (ec.edge_weighted_contract_grouped.launches,
              ec.edge_weighted_contract_grouped.bwd_launches)
    outs = ec.edge_weighted_contract_grouped(Tt, Wt)
    for g, out in enumerate(outs):
        assert out.dtype == torch.float32 and out.shape == cots[g].shape
        for want in (pallas_tp.edge_weighted_contract(jT[g], jW[g], te=32,
                                                      force="interpret"),
                     pallas_tp._contract_xla(jT[g], jW[g])):
            np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                       atol=tol)

    def loss(Ts, Ws):
        return sum(jnp.sum(pallas_tp.edge_weighted_contract(
            T, W, te=32, force="interpret") * c)
            for T, W, c in zip(Ts, Ws, cots))

    gT, gW = jax.grad(loss, argnums=(0, 1))(jT, jW)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for got, ref in zip(Tt + Wt, list(gT) + list(gW)):
        ref = np.asarray(ref.astype(jnp.float32))
        scale = max(float(np.abs(ref).max()), 1.0)
        assert got.grad.dtype == got.dtype
        np.testing.assert_allclose(got.grad.float().numpy(), ref,
                                   atol=tol * scale)
    assert (ec.edge_weighted_contract_grouped.launches,
            ec.edge_weighted_contract_grouped.bwd_launches) == before


@pytest.mark.parametrize("ins,sh,out", [
    ("4x0e+4x1o+4x2e", "1x0e+1x1o+1x2e", "4x0e+12x0e+4x1o+4x2e"),
    ("2x0e+1x1o+3x2e", "1x0e+1x1o", "3x0e+2x1o+1x1e+2x2e")])
def test_edge_tensor_product_makes_one_grouped_call(monkeypatch, ins, sh, out):
    """``EdgeTensorProduct.apply`` (combined CG and per path) contracts all
    output irreps in one ``edge_weighted_contract_grouped`` call, with the
    group shapes it reports, and matches the JAX layer."""
    calls = []

    def counting(Ts, Ws):
        calls.append([(T.shape[1], T.shape[2], W.shape[2])
                      for T, W in zip(Ts, Ws)])
        return ec.edge_weighted_contract_grouped(Ts, Ws)

    monkeypatch.setattr(ttp, "edge_weighted_contract_grouped", counting)
    jt = jtp.EdgeTensorProduct(jir.Irreps(ins), jir.Irreps(sh),
                               jir.Irreps(out))
    tt = ttp.EdgeTensorProduct(tir.Irreps(ins), tir.Irreps(sh),
                               tir.Irreps(out))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9, tir.Irreps(ins).dim)).astype(np.float32)
    s = rng.normal(size=(9, tir.Irreps(sh).dim)).astype(np.float32)
    w = rng.normal(size=(9, tt.weight_numel)).astype(np.float32)
    got = tt.apply(*(torch.from_numpy(a) for a in (x, s, w)))
    assert len(calls) == 1
    if tt._uniform_mul is not None:
        assert calls[0] == tt.group_shapes
    want = jt.apply(jnp.asarray(x), jnp.asarray(s), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


TFN_HIDDEN = [(256, 1, 64), (256, 1, 192), (384, 3, 64), (448, 5, 64),
              (384, 7, 64)]


def test_contract_plan_of_a_tfn_hidden_layer():
    """f32 W at E 1400: 16 row slices of 16 vector columns a block for w 64,
    5 slices of 48 for the gates; the largest W block per item first."""
    shapes = [(1400, k, m, w) for k, m, w in TFN_HIDDEN]
    plan = ec.contract_plan(shapes, 4)
    assert [p["group"] for p in plan] == [1, 3, 2, 4, 0]
    by_group = {p["group"]: p for p in plan}
    assert (by_group[0]["cols"], by_group[0]["ks"], by_group[0]["epb"]) == \
        (16, 16, 1)
    assert (by_group[1]["cols"], by_group[1]["ks"], by_group[1]["tpi"]) == \
        (48, 5, 240)
    assert [p["item0"] for p in plan] == [0, 1400, 2800, 4200, 5600]
    # the ring (3 slots of 16 KB, mbarriers), two T buffers of the m 7
    # group and its partial sums: 2 blocks fit an SM (228 KB, 1 KB of each
    # block reserved)
    two_blocks = 228 * 1024 // 2 - 1024
    size, slot, fofs, tmax, omax = ec.smem_layout(plan, shapes, False, 4)
    assert (slot, fofs, tmax, omax) == (16384, 3 * 16384 + 128, 384 * 7, 0)
    assert size == fofs + 4 * (2 * 384 * 7 + 16 * 64 * 7) <= two_blocks
    size, *_ = ec.smem_layout(plan, shapes, True, 4)
    assert size <= two_blocks


@pytest.mark.parametrize("E,K,m,w,vec", [
    (1400, 64, 1, 64, 4), (1400, 64, 7, 192, 4), (1400, 448, 5, 64, 8),
    (1, 8, 15, 8, 8), (37, 33, 15, 24, 8), (5, 1, 3, 300, 4), (0, 16, 1, 8, 4),
    (1400, 33, 15, 24, 8)])   # small groups: the shared arrays bound epb
def test_contract_plan_layout(E, K, m, w, vec):
    """Every sub-block's threads fit the block and its edges' shared arrays
    the item's share, each thread streams at least 16 rows where K allows,
    and the items cover the edges."""
    (p,) = ec.contract_plan([(E, K, m, w)], vec)
    cols = w // vec
    assert p["cols"] == cols and p["tpi"] == p["ks"] * cols
    assert p["epb"] * p["tpi"] <= ec.THREADS and p["epb"] >= 1
    assert p["epb"] == 1 or p["epb"] * ec.edge_floats(
        K, m, w, p["ks"], cols) <= ec.SMEM_ITEM
    assert p["ks"] <= max(1, -(-K // ec.ROWS_PER_THREAD))
    assert p["items"] == -(-E // p["epb"]) and p["item0"] == 0

    def busy(ks):   # threads at work with ks slices
        fit = ec.SMEM_ITEM // ec.edge_floats(K, m, w, ks, cols)
        return max(1, min(ec.THREADS // (ks * cols), fit)) * ks * cols

    assert p["epb"] * p["tpi"] == max(busy(k) for k in range(1, p["ks"] + 1))


def test_contract_plan_small_k_packs_edges():
    """Layer 0 (K 64): 4 row slices, 4 edges a block; bf16 at K 448: 28
    slices of 8 columns, one edge a block (two edges' shared arrays would
    pass SMEM_ITEM), 224 threads busy."""
    (p,) = ec.contract_plan([(1400, 64, 3, 64)], 4)
    assert (p["ks"], p["tpi"], p["epb"], p["items"]) == (4, 64, 4, 350)
    (p,) = ec.contract_plan([(1400, 448, 5, 64)], 8)
    assert (p["cols"], p["ks"], p["epb"]) == (8, 28, 1)


def test_contract_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple"):
        ec.contract_plan([(4, 8, 1, 6)], 4)
    with pytest.raises(ValueError, match="vector columns"):
        ec.contract_plan([(4, 8, 1, 1028)], 4)
