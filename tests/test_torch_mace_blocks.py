"""The port's MACE block library against the JAX package's: the 'uvu' path
enumeration (``irreps.tp_paths_uvu``), the four forms of
``EdgeTensorProductUVU`` and its dispatch, both paths of
``FullyConnectedTensorProduct`` (and its node blocks), the five interaction
blocks (forward and every gradient, chunked convolutions too), the readout,
embedding, scale-shift, atomic-energy and element-dependent weight blocks,
and ``EquivariantProductBasisBlock``'s node blocks.  JAX parameters are
carried over by name (the port's modules carry the flax names).  On the
CPU every K4 call takes its plain version.

Tolerances: module outputs 1e-5 absolute / 1e-4 relative (f32 products in
another order); gradients 2e-4 of max(|ref|, 1) per parameter, as for
MACE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import irreps as jirreps
from geometric_message_passing_tpu.nn import mace_blocks as jmb
from geometric_message_passing_tpu.nn import tensor_product as jtp
from geometric_message_passing_tpu.ops.spherical import (
    spherical_harmonics as jax_sh)
from geometric_message_passing_tpu_torch import irreps
from geometric_message_passing_tpu_torch.irreps import Irreps
from geometric_message_passing_tpu_torch.nn import conv
from geometric_message_passing_tpu_torch.nn import mace_blocks as mb
from geometric_message_passing_tpu_torch.nn import tensor_product as tp

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _flat(tree, prefix=""):
    """A flax parameter tree as ``{"a.b.w0": array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v, np.float32)
    return out


def _load(module, tree):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            _flat(tree).items()}, strict=True)


def _close_grads(module, jax_grads):
    want = _flat(jax_grads)
    assert {n for n, _ in module.named_parameters()} == set(want)
    for name, p in module.named_parameters():
        ref = want[name]
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name, rtol=0,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("in1,in2,target", [
    ("8x0e", "1x0e+1x1o+1x2e+1x3o", "8x0e+8x1o+8x2e+8x3o"),
    ("4x0e+4x1o+4x2e", "1x0e+1x1o+1x2e", "4x0e+4x1o+4x2e"),
    ("3x0e+2x1o+5x1e", "1x0e+1x1o", "3x0e+3x1o+3x1e+2x2e"),
    ("4x0e+4x1o+4x2e+4x3o", "1x0e+1x1o+1x2e+1x3o", "4x0e+4x1o+4x2e+4x3o")])
def test_tp_paths_uvu_match_jax(in1, in2, target):
    got_out, got = irreps.tp_paths_uvu(Irreps(in1), Irreps(in2), Irreps(target))
    want_out, want = jirreps.tp_paths_uvu(jirreps.Irreps(in1),
                                          jirreps.Irreps(in2),
                                          jirreps.Irreps(target))
    assert repr(got_out) == repr(want_out)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.i_in1, a.i_in2, a.i_out, a.mul_in1, a.mul_in2, a.mul_out,
                repr(a.ir_in1), repr(a.ir_in2), repr(a.ir_out)) == (
                    b.i_in1, b.i_in2, b.i_out, b.mul_in1, b.mul_in2,
                    b.mul_out, repr(b.ir_in1), repr(b.ir_in2), repr(b.ir_out))
        assert a.path_weight == pytest.approx(b.path_weight, rel=1e-12)


def _uvu_pair(hidden, sh, e, seed):
    t = tp.EdgeTensorProductUVU(Irreps(hidden), Irreps(sh), Irreps(hidden))
    j = jtp.EdgeTensorProductUVU(jirreps.Irreps(hidden), jirreps.Irreps(sh),
                                 jirreps.Irreps(hidden))
    args = (_x((e, t.irreps_in.dim), seed), _x((e, t.irreps_sh.dim), seed + 1),
            _x((e, t.weight_numel), seed + 2))
    return t, j, args


FORMS = ("_apply_combined", "_apply_bcast", "_apply_pair_grouped",
         "_apply_per_path")


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("hidden,sh", [
    ("4x0e+4x1o+4x2e", "1x0e+1x1o+1x2e"),
    ("8x0e+8x1o+8x2e+8x3o", "1x0e+1x1o+1x2e+1x3o")])
def test_uvu_forms_match_jax_and_each_other(form, hidden, sh):
    t, j, args = _uvu_pair(hidden, sh, 57, seed=1)
    want = np.asarray(jax.jit(getattr(j, form))(*map(jnp.asarray, args)))
    x, s, w = (torch.from_numpy(a).requires_grad_() for a in args)
    got = getattr(t, form)(x, s, w)
    assert got.shape == (57, t.irreps_out.dim)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    # every form's gradient equals JAX's per-path form's
    c = _x(want.shape, 9)

    def loss(x_, s_, w_):
        return jnp.sum(j._apply_per_path(x_, s_, w_) * c)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray,
                                                           args))
    (got * torch.from_numpy(c)).sum().backward()
    for mine, ref in zip((x, s, w), grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def test_uvu_dispatch_by_edges_and_grouping(monkeypatch):
    """Up to COMBINED_MAX_EDGES (4096) the combined form, above it the form
    ``grouping`` names (``bcast`` by default): at E 4100 with narrow irreps
    the port's ``apply`` takes the form JAX's takes, with its values."""
    assert tp.EdgeTensorProductUVU.COMBINED_MAX_EDGES == 4096
    assert tp.EdgeTensorProductUVU.LARGE_GROUPING == "bcast"
    hidden, sh = "2x0e+2x1o", "1x0e+1x1o"
    taken = []
    for form in FORMS:
        orig = getattr(tp.EdgeTensorProductUVU, form)
        monkeypatch.setattr(tp.EdgeTensorProductUVU, form,
                            lambda self, *a, _f=form, _o=orig: (
                                taken.append(_f), _o(self, *a))[1])
    for e, grouping, form in ((4096, None, "_apply_combined"),
                              (4100, None, "_apply_bcast"),
                              (4100, "pair", "_apply_pair_grouped"),
                              (4100, "path", "_apply_per_path")):
        t = tp.EdgeTensorProductUVU(Irreps(hidden), Irreps(sh), Irreps(hidden),
                                    grouping=grouping)
        j = jtp.EdgeTensorProductUVU(jirreps.Irreps(hidden),
                                     jirreps.Irreps(sh),
                                     jirreps.Irreps(hidden), grouping=grouping)
        args = (_x((e, t.irreps_in.dim), 3), _x((e, t.irreps_sh.dim), 4),
                _x((e, t.weight_numel), 5))
        taken.clear()
        got = t.apply(*map(torch.from_numpy, args)).numpy()
        assert taken == [form]
        np.testing.assert_allclose(got, np.asarray(j.apply(*map(jnp.asarray,
                                                                args))),
                                   atol=ATOL, rtol=RTOL)
    # non-uniform multiplicities: per path at any E
    t = tp.EdgeTensorProductUVU(Irreps("2x0e+3x1o"), Irreps(sh),
                                Irreps("2x0e+3x1o+2x1o"))
    taken.clear()
    t.apply(*(torch.from_numpy(_x((5, d), 6)) for d in (
        t.irreps_in.dim, t.irreps_sh.dim, t.weight_numel)))
    assert taken == ["_apply_per_path"]


def _fctp_pair(in1, in2, out, seed, n=7, node_chunk=None):
    j = jtp.FullyConnectedTensorProduct(jirreps.Irreps(in1),
                                        jirreps.Irreps(in2),
                                        jirreps.Irreps(out))
    x1 = _x((n, Irreps(in1).dim), seed)
    x2 = _x((n, Irreps(in2).dim), seed + 1)
    v = j.init(jax.random.PRNGKey(seed), jnp.asarray(x1), jnp.asarray(x2))
    t = tp.FullyConnectedTensorProduct(Irreps(in1), Irreps(in2), Irreps(out),
                                       node_chunk=node_chunk, generator=_gen())
    _load(t, v["params"])
    return j, v, t, x1, x2


@pytest.mark.parametrize("in1,in2,out,combined", [
    ("4x0e+4x1o+4x2e", "3x0e", "4x0e+4x1o+4x2e", True),       # skip_tp
    ("4x0e", "3x0e", "4x0e+4x1o+4x2e", True),
    ("3x0e+2x1o", "2x0e+1x1o", "2x0e+3x1o+2x2e", False),
    ("2x0e+3x1o", "3x0e", "2x0e+3x1o", False)])               # mixed muls
def test_fctp_paths_match_jax(in1, in2, out, combined):
    j, v, t, x1, x2 = _fctp_pair(in1, in2, out, seed=11)
    assert t.combined == combined
    c = _x((x1.shape[0], Irreps(out).dim), 12)

    def loss(params, a):
        y = j.apply({"params": params}, a, jnp.asarray(x2))
        return jnp.sum(y * c), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x1))
    a = torch.from_numpy(x1).requires_grad_()
    got = t(a, torch.from_numpy(x2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    (got * torch.from_numpy(c)).sum().backward()
    _close_grads(t, gp)
    gx = np.asarray(gx)
    np.testing.assert_allclose(a.grad.numpy(), gx, rtol=0,
                               atol=GRAD_REL * max(np.abs(gx).max(), 1.0))


@pytest.mark.parametrize("combined", [True, False])
def test_fctp_node_blocks_match_one_pass(combined):
    """``node_chunk`` 3 over 8 rows (blocks 3, 3, 2 + one zero pad row):
    forward and gradients equal the single pass and JAX's."""
    in2 = "3x0e" if combined else "2x0e+1x1o"
    j, v, t, x1, x2 = _fctp_pair("2x0e+2x1o", in2, "2x0e+2x1o", seed=13, n=8)
    t_chunked = tp.FullyConnectedTensorProduct(
        Irreps("2x0e+2x1o"), Irreps(in2), Irreps("2x0e+2x1o"), node_chunk=3,
        generator=_gen(1))
    t_chunked.load_state_dict(t.state_dict())
    want = np.asarray(j.apply(v, jnp.asarray(x1), jnp.asarray(x2)))
    c = torch.from_numpy(_x(want.shape, 14))
    outs = []
    for module in (t, t_chunked):
        a = torch.from_numpy(x1).requires_grad_()
        y = module(a, torch.from_numpy(x2))
        (y * c).sum().backward()
        outs.append((y.detach(), a.grad, {n: p.grad for n, p in
                                          module.named_parameters()}))
    np.testing.assert_allclose(outs[1][0].numpy(), want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=ATOL, rtol=RTOL)
    for name, g in outs[0][2].items():
        torch.testing.assert_close(outs[1][2][name], g, atol=ATOL, rtol=RTOL)


def _graph(seed=0, n=6, e=20, channels=4, lmax=2, elements=3):
    """The JAX test's graph (``tests/test_mace_blocks.py::setup_graph``),
    with a third of the edges masked off."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    senders = rng.integers(0, n, e).astype(np.int32)
    receivers = rng.integers(0, n, e).astype(np.int32)
    one_hot = np.eye(elements, dtype=np.float32)[rng.integers(0, elements, n)]
    edge_feats = rng.normal(size=(e, 8)).astype(np.float32)
    hidden = (jirreps.Irreps.spherical_harmonics(lmax) * channels
              ).sort().simplify()
    feats = rng.normal(size=(n, hidden.dim)).astype(np.float32)
    vecs = pos[senders] - pos[receivers]
    sh = np.asarray(jax_sh(jnp.asarray(vecs), lmax))
    mask = rng.random(e) > 0.33
    return dict(one_hot=one_hot, feats=feats, sh=sh, edge_feats=edge_feats,
                senders=senders, receivers=receivers, mask=mask,
                hidden=str(hidden), lmax=lmax, elements=elements)


def _block_kw(g, jax_side: bool):
    I = jirreps.Irreps if jax_side else Irreps
    sh = I.spherical_harmonics(g["lmax"])
    return dict(node_attrs_irreps=I(f"{g['elements']}x0e"),
                node_feats_irreps=I(g["hidden"]), edge_attrs_irreps=sh,
                edge_feats_irreps=I("8x0e"), target_irreps=I(g["hidden"]),
                hidden_irreps=I(g["hidden"]), avg_num_neighbors=3.0)


def _torch_block(name, g, **kw):
    k = _block_kw(g, jax_side=False)
    cls = mb.interaction_classes[name]
    return cls(k.pop("node_attrs_irreps"), k.pop("node_feats_irreps"),
               k.pop("edge_attrs_irreps"), k.pop("edge_feats_irreps"),
               k.pop("target_irreps"), k.pop("hidden_irreps"), **k, **kw,
               generator=_gen())


def _block_inputs(g, lib):
    arr = jnp.asarray if lib == "jax" else torch.from_numpy
    return [arr(g[k]) for k in ("one_hot", "feats", "sh", "edge_feats",
                                "senders", "receivers", "mask")]


def _outputs(out):
    return out if isinstance(out, tuple) else (out, None)


@pytest.mark.parametrize("name", sorted(jmb.interaction_classes))
def test_interaction_blocks_match_jax(name):
    g = _graph()
    jblock = jmb.interaction_classes[name](**_block_kw(g, jax_side=True))
    jin = _block_inputs(g, "jax")
    v = jax.jit(jblock.init)(jax.random.PRNGKey(0), *jin)
    m0, sc0 = _outputs(jax.eval_shape(jblock.apply, v, *jin))
    c = [None if o is None else _x(o.shape, 20 + i)
         for i, o in enumerate((m0, sc0))]

    def loss(params, feats):
        m, sc = _outputs(jblock.apply({"params": params}, jin[0], feats,
                                      *jin[2:]))
        total = jnp.sum(m * c[0])
        if sc is not None:
            total = total + jnp.sum(sc * c[1])
        return total, (m, sc)

    (_, (m, sc)), (gp, gf) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], jin[1])
    block = _torch_block(name, g)
    _load(block, v["params"])
    tin = _block_inputs(g, "torch")
    tin[1].requires_grad_()
    tm, tsc = _outputs(block(*tin))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(m), atol=ATOL,
                               rtol=RTOL)
    assert (tsc is None) == (sc is None)
    total = (tm * torch.from_numpy(c[0])).sum()
    if tsc is not None:
        np.testing.assert_allclose(tsc.detach().numpy(), np.asarray(sc),
                                   atol=ATOL, rtol=RTOL)
        total = total + (tsc * torch.from_numpy(c[1])).sum()
    total.backward()
    _close_grads(block, gp)
    gf = np.asarray(gf)
    np.testing.assert_allclose(tin[1].grad.numpy(), gf, rtol=0,
                               atol=GRAD_REL * max(np.abs(gf).max(), 1.0))


@pytest.mark.parametrize("name", ["RealAgnosticResidualInteractionBlock",
                                  "RealAgnosticInteractionBlock"])
@pytest.mark.parametrize("fold", [False, True])
def test_chunked_convolution_matches_one_pass(name, fold, monkeypatch):
    """Edge chunks of 7 over 20 edges (the tail padded with index 0 and mask
    False) and node blocks of 4 over 6 nodes, with the post-conv linear
    folded into the chunks or not: the same values and gradients as one
    pass (sums in another order)."""
    g = _graph(seed=1)
    one = _torch_block(name, g)
    chunked = _torch_block(name, g, edge_chunk=7, node_chunk=4)
    chunked.load_state_dict(one.state_dict())
    if fold:
        monkeypatch.setattr(mb._InteractionBase, "FOLD_ACC_ELEMS", 0)
    outs = []
    for block in (one, chunked):
        tin = _block_inputs(g, "torch")
        tin[1].requires_grad_()
        m, sc = _outputs(block(*tin))
        total = (m * torch.from_numpy(_x(m.shape, 30))).sum()
        if sc is not None:
            total = total + (sc * torch.from_numpy(_x(sc.shape, 31))).sum()
        total.backward()
        outs.append((m.detach(), tin[1].grad,
                     {n: p.grad for n, p in block.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=ATOL, rtol=RTOL)
    for n, grad in outs[0][2].items():
        torch.testing.assert_close(outs[1][2][n], grad, atol=ATOL, rtol=RTOL,
                                   msg=n)


def test_block_tables_match_jax():
    assert mb.gate_dict == jmb.gate_dict
    assert sorted(mb.interaction_classes) == sorted(jmb.interaction_classes)


def test_small_blocks_match_jax():
    hidden = "4x0e+4x1o"
    x = _x((5, Irreps(hidden).dim), 40)
    one = {"IrrepsLinear_0.": "linear."}
    two = {"IrrepsLinear_0.": "linear_0.", "IrrepsLinear_1.": "linear_1."}
    cases = [   # (JAX block, port block, inputs, flax prefix -> port's)
        (jmb.LinearReadoutBlock(jirreps.Irreps(hidden)),
         mb.LinearReadoutBlock(Irreps(hidden), generator=_gen()), (x,), one),
        (jmb.NonLinearReadoutBlock(jirreps.Irreps(hidden),
                                   jirreps.Irreps("8x0e")),
         mb.NonLinearReadoutBlock(Irreps(hidden), Irreps("8x0e"),
                                  generator=_gen()), (x,), two),
        (jmb.LinearNodeEmbeddingBlock(jirreps.Irreps("3x0e"),
                                      jirreps.Irreps("6x0e")),
         mb.LinearNodeEmbeddingBlock(Irreps("3x0e"), Irreps("6x0e"),
                                     generator=_gen()),
         (np.eye(3, dtype=np.float32)[[0, 2, 1, 1, 0]],), one),
        (jmb.E3FullyConnectedNet((16, 16, 7)),
         mb.E3FullyConnectedNet(8, (16, 16, 7), generator=_gen()),
         (_x((9, 8), 41),), {}),
        (jmb.TensorProductWeightsBlock(3, 8, 11),
         mb.TensorProductWeightsBlock(3, 8, 11, generator=_gen()),
         (np.eye(3, dtype=np.float32)[[0, 2, 1, 1]], _x((4, 8), 42)), {}),
    ]
    for jm, tm, args, rename in cases:
        v = jm.init(jax.random.PRNGKey(1), *map(jnp.asarray, args))
        sd = {}
        for key, a in _flat(v["params"]).items():
            for old, new in rename.items():
                key = key.replace(old, new)
            sd[key] = torch.from_numpy(a)
        tm.load_state_dict(sd, strict=True)
        got = tm(*map(torch.from_numpy, args)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(
            v, *map(jnp.asarray, args))), atol=ATOL, rtol=RTOL)
    ss = mb.ScaleShiftBlock(scale=2.0, shift=1.0)
    np.testing.assert_allclose(ss(torch.tensor([1.0, 2.0])).numpy(), np.asarray(
        jmb.ScaleShiftBlock(scale=2.0, shift=1.0)(jnp.asarray([1.0, 2.0]))))
    one_hot = np.asarray([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0]], np.float32)
    je = jmb.AtomicEnergiesBlock((1.0, -2.0))
    want = np.asarray(je.init_with_output(jax.random.PRNGKey(0),
                                          jnp.asarray(one_hot))[0])
    got = mb.AtomicEnergiesBlock((1.0, -2.0))(torch.from_numpy(one_hot))
    np.testing.assert_allclose(got.numpy(), want)
    assert not mb.AtomicEnergiesBlock((1.0,)).state_dict()


def test_weight_block_init_scales():
    """Glorot uniform over the element axis as the batch axis; the weight
    MLP's weights from N(0, 1)."""
    w = mb.TensorProductWeightsBlock(8, 8, 300, generator=_gen()).weights
    bound = np.sqrt(6.0 / (8 + 300))
    assert w.abs().max().item() <= bound
    assert w.abs().max().item() > 0.9 * bound
    net = mb.E3FullyConnectedNet(8, (64, 64), generator=_gen())
    assert abs(net.w0.std().item() - 1.0) < 0.05


def test_product_block_node_blocks_match_one_pass():
    """``node_chunk`` 4 over 10 nodes: values and gradients of the single
    pass, with the self-connection chunked beside the features."""
    h = Irreps("4x0e+4x1o+4x2e")
    x = torch.from_numpy(_x((10, 4, 9), 50))
    skip = torch.from_numpy(_x((10, h.dim), 51))
    one = conv.EquivariantProductBasisBlock(h, h, 3, generator=_gen())
    chunked = conv.EquivariantProductBasisBlock(h, h, 3, node_chunk=4,
                                                generator=_gen(1))
    chunked.load_state_dict(one.state_dict())
    c = torch.from_numpy(_x((10, h.dim), 52))
    outs = []
    for block in (one, chunked):
        a, s = x.clone().requires_grad_(), skip.clone().requires_grad_()
        y = block(a, s)
        (y * c).sum().backward()
        outs.append([y.detach(), a.grad, s.grad] + [
            p.grad for _, p in block.named_parameters()])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
