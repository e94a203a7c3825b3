"""The port's edge tensor product (``nn/tensor_product.py``) and
``TensorProductConvLayer`` (``nn/conv.py``) against the JAX package's, on
the CPU (K7's plain version): both ``EdgeTensorProduct`` forms (the combined
CG for a uniform input multiplicity, per path otherwise), ``apply`` against
``apply_grouped``, the golden values of ``tests/test_e3nn_golden.py``, and
the conv layer's output and gradients with the JAX layer's weights carried
over, with and without gate, batch norm, mean aggregation and bf16 heads.
f32 tolerances 1e-5 absolute / 1e-4 relative (sums in another order),
gradients 2e-4 of max(|ref|, 1); bf16 heads 2e-2."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import irreps as jir
from geometric_message_passing_tpu.nn import conv as jconv
from geometric_message_passing_tpu.nn import tensor_product as jtp
from geometric_message_passing_tpu_torch import irreps as tir
from geometric_message_passing_tpu_torch.nn import conv as tconv
from geometric_message_passing_tpu_torch.nn import tensor_product as ttp
from geometric_message_passing_tpu_torch.weights import tfn_from_jax

SH = "1x0e+1x1o+1x2e"
CASES = [("4x0e", SH, "4x0e+12x0e+4x1o+4x2e"),                # layer 0
         ("4x0e+4x1o+4x2e", SH, "4x0e+12x0e+4x1o+4x2e"),      # hidden
         ("2x0e+1x1o+3x2e", "1x0e+1x1o", "3x0e+2x1o+1x1e+2x2e")]  # per path


def _tp_inputs(ins, sh, tp, e=11, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, tir.Irreps(ins).dim)).astype(np.float32)
    s = rng.normal(size=(e, tir.Irreps(sh).dim)).astype(np.float32)
    w = rng.normal(size=(e, tp.weight_numel)).astype(np.float32)
    return x, s, w


@pytest.mark.parametrize("ins,sh,out", CASES)
def test_edge_tensor_product_matches_jax(ins, sh, out):
    jt = jtp.EdgeTensorProduct(jir.Irreps(ins), jir.Irreps(sh), jir.Irreps(out))
    tt = ttp.EdgeTensorProduct(tir.Irreps(ins), tir.Irreps(sh), tir.Irreps(out))
    assert tt.weight_numel == jt.weight_numel
    assert tt.group_weight_numels == jt.group_weight_numels
    assert (tt._uniform_mul is None) == (jt._uniform_mul is None)
    if tt._uniform_mul is not None:
        np.testing.assert_array_equal(tt._C, jt._C)
    x, s, w = _tp_inputs(ins, sh, tt)
    c = np.random.default_rng(9).normal(
        size=(x.shape[0], tir.Irreps(out).dim)).astype(np.float32)
    want = np.asarray(jt.apply(jnp.asarray(x), jnp.asarray(s), jnp.asarray(w)))
    grads = jax.grad(lambda *a: jnp.sum(jt.apply(*a) * c), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(w))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, s, w)]
    got = tt.apply(*ts)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-4)
    (got * torch.from_numpy(c)).sum().backward()
    for t, g in zip(ts, grads):
        ref = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), ref,
                                   atol=2e-4 * max(np.abs(ref).max(), 1.0))
    # the grouped form on the same weights, split per group
    split = np.cumsum(tt.group_weight_numels)[:-1]
    grouped = tt.apply_grouped(torch.from_numpy(x), torch.from_numpy(s),
                               [torch.from_numpy(p) for p in
                                np.split(w, split, axis=-1)])
    np.testing.assert_allclose(grouped.numpy(), got.detach().numpy(),
                               atol=1e-6)


def test_group_shapes_of_the_tfn_star_layers():
    """The (K, m, w) of TFN's five groups at emb_dim 64, max_ell 3."""
    sh = tir.Irreps.spherical_harmonics(3)
    hidden = (sh * 64).sort().simplify()
    tp_out = tir.Irreps("64x0e+192x0e+64x1o+64x2e+64x3o")
    hid = ttp.EdgeTensorProduct(hidden, sh, tp_out)
    first = ttp.EdgeTensorProduct(tir.Irreps("64x0e"), sh, tp_out)
    assert hid.group_shapes == [(256, 1, 64), (256, 1, 192), (384, 3, 64),
                                (448, 5, 64), (384, 7, 64)]
    assert first.group_shapes == [(64, 1, 64), (64, 1, 192), (64, 3, 64),
                                  (64, 5, 64), (64, 7, 64)]
    assert hid.weight_numel == 143_360 and first.weight_numel == 28_672


# --- golden values (tests/test_e3nn_golden.py) on the port ---


def test_golden_scalar_times_vector_and_fan_in():
    tp = ttp.EdgeTensorProduct(tir.Irreps("1x0e"), tir.Irreps("1x1o"),
                               tir.Irreps("1x1o"))
    rng = np.random.default_rng(0)
    s, V, w = (rng.standard_normal((4, d)).astype(np.float32)
               for d in (1, 3, 1))
    out = tp.apply(*map(torch.from_numpy, (s, V, w))).numpy()
    sign = np.sign(tir.wigner_3j(1, 0, 1)[0, 0, 0])
    np.testing.assert_allclose(out, sign * w * s * V, rtol=1e-5, atol=1e-6)
    tp2 = ttp.EdgeTensorProduct(tir.Irreps("1x0e+1x2e"), tir.Irreps("1x1o"),
                                tir.Irreps("1x1o"))
    x2 = np.concatenate([s, np.zeros((4, 5), np.float32)], axis=-1)
    out2 = tp2.apply(torch.from_numpy(x2), torch.from_numpy(V),
                     torch.ones((4, tp2.weight_numel))).numpy()
    out1 = tp.apply(torch.from_numpy(s), torch.from_numpy(V),
                    torch.ones((4, 1))).numpy()
    np.testing.assert_allclose(out2, out1 / math.sqrt(2), rtol=1e-5, atol=1e-6)


def test_golden_vector_vector_projections():
    """In float64 (the combined CG constant is float32, as in JAX)."""
    tp = ttp.EdgeTensorProduct(tir.Irreps("1x1o"), tir.Irreps("1x1o"),
                               tir.Irreps("1x0e+1x1e+1x2e"))
    rng = np.random.default_rng(1)
    x, y, w = (rng.standard_normal((16, 3)) for _ in range(3))
    out = tp.apply(*(torch.from_numpy(a) for a in (x, y, w))).numpy()
    dots = (x * y).sum(-1)
    cross2 = np.square(np.cross(x, y)).sum(-1)
    n2 = (x * x).sum(-1) * (y * y).sum(-1)
    np.testing.assert_allclose(np.abs(out[:, 0]),
                               np.abs(w[:, 0] * dots / math.sqrt(3)), rtol=1e-6)
    np.testing.assert_allclose(np.square(out[:, 1:4]).sum(-1),
                               w[:, 1]**2 * cross2 / 2.0, rtol=1e-6)
    np.testing.assert_allclose(
        np.square(out[:, 4:9]).sum(-1),
        w[:, 2]**2 * ((n2 + dots**2) / 2.0 - dots**2 / 3.0), rtol=1e-6)


# --- the conv layer ---


def _conv_inputs(n=9, e=30, in_dim=8, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, in_dim)).astype(np.float32)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    v = rng.normal(size=(e, 9)).astype(np.float32)
    feats = rng.normal(size=(e, 6)).astype(np.float32)
    emask = rng.random(e) > 0.2
    nmask = np.arange(n) < n - 2
    return h, snd, rcv, v, feats, emask, nmask


@pytest.mark.parametrize("in_irreps,kw", [
    ("4x0e", dict(gate=True)),
    ("4x0e+4x1o+4x2e", dict(gate=True, batch_norm=True)),
    ("4x0e+4x1o+4x2e", dict(aggr="mean")),
    ("4x0e", dict(gate=True, weights_bf16=True))])
def test_conv_layer_matches_jax(in_irreps, kw):
    hidden = "4x0e+4x1o+4x2e"
    h, snd, rcv, sh, feats, emask, nmask = _conv_inputs(
        in_dim=tir.Irreps(in_irreps).dim)
    args = (snd, rcv, sh, feats)
    jl = jconv.TensorProductConvLayer(jir.Irreps(in_irreps), jir.Irreps(hidden),
                                      jir.Irreps(SH), mlp_dim=16, **kw)
    jargs = [jnp.asarray(a) for a in (h, *args)]
    variables = jl.init(jax.random.PRNGKey(0), *jargs,
                        edge_mask=jnp.asarray(emask),
                        node_mask=jnp.asarray(nmask))
    tl = tconv.TensorProductConvLayer(
        tir.Irreps(in_irreps), tir.Irreps(hidden), tir.Irreps(SH), edge_dim=6,
        mlp_dim=16, generator=torch.Generator().manual_seed(0), **kw)
    tree = {"params": {"emb_in": {"embedding": np.zeros((1, 1), np.float32)},
                       "conv_0": jax.tree.map(np.asarray, variables["params"])},
            "batch_stats": {"conv_0": jax.tree.map(
                np.asarray, variables.get("batch_stats", {}))}}
    sd = {k[len("convs.0."):]: v for k, v in tfn_from_jax(tree).items()
          if k.startswith("convs.0.")}
    tl.load_state_dict(sd, strict=True)
    c = np.random.default_rng(5).normal(
        size=(h.shape[0], tir.Irreps(hidden).dim)).astype(np.float32)
    train = bool(kw.get("batch_norm"))

    def loss(params, x):
        out = jl.apply({**variables, "params": params}, x, *jargs[1:],
                       edge_mask=jnp.asarray(emask),
                       node_mask=jnp.asarray(nmask), train=train,
                       mutable=["batch_stats"])[0]
        return jnp.sum(out * c), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
        variables["params"], jargs[0])
    x = torch.from_numpy(h).requires_grad_(True)
    tl.train(train)
    got = tl(x, *(torch.from_numpy(a) for a in args),
             edge_mask=torch.from_numpy(emask),
             node_mask=torch.from_numpy(nmask))
    bf16 = kw.get("weights_bf16", False)
    atol, grel = (2e-2, 2e-2) if bf16 else (1e-5, 2e-4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-4 if not bf16 else 2e-2)
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx),
                               atol=grel * max(np.abs(np.asarray(gx)).max(), 1))
    want_grads = tfn_from_jax({"params": {
        "emb_in": {"embedding": np.zeros((1, 1), np.float32)},
        "conv_0": jax.tree.map(np.asarray, gp)}})
    for name, p in tl.named_parameters():
        ref = want_grads[f"convs.0.{name}"].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name,
                                   atol=grel * max(np.abs(ref).max(), 1.0))
