"""The port's triplet pipeline against the JAX package's: triplet and quad
indices (``triplets.py``) index for index on random graphs, star batches,
both batch paths (``batch_triplets`` through ``GraphLoader``, and the slot
layout of ``build_slot_data`` / ``assemble_batch``) and ``attach_triplets``;
``idx_ji`` ascending on every path and a ``ValueError`` where it is not;
the triplet fold's identity plan (``ops.sorted_segsum.ascending_plan``);
``segment_sum_into``, ``segment_min`` and ``segment_softmax``;
``safe_arctan2`` at the origin; and every DimeNet/SphereNet basis function
(``ops.dimenet_basis``), x near 0 and the pad distance 0 included.

Tolerances: indices exact; segment reductions and bases 1e-5 absolute /
1e-4 relative of the float32 JAX value (sums in another order, ``pow`` and
``sin`` rounding); gradients at the origin exact (0 or 1)."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import triplets as jtri
from geometric_message_passing_tpu.ops import dimenet_basis as jbasis
from geometric_message_passing_tpu.ops import norms as jnorms
from geometric_message_passing_tpu.ops import scatter as jscatter
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch import triplets as ttri
from geometric_message_passing_tpu_torch.ops import dimenet_basis as tbasis
from geometric_message_passing_tpu_torch.ops import norms as tnorms
from geometric_message_passing_tpu_torch.ops import scatter as tscatter
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

ATOL, RTOL = 1e-5, 1e-4
TRI = ("idx_i", "idx_j", "idx_k", "idx_kj", "idx_ji", "t_mask")
QUAD = ("q_trip", "q_kn", "q_mask")


@pytest.fixture(autouse=True)
def fresh_jax_triplet_cache():
    """The JAX package caches each graph's triplets under ``id(graph)``
    without keeping the graph alive, so a graph freed by an earlier test can
    hand its id, and its stale triplets, to a new one.  Start each test with
    that cache empty (the port's cache keys on the graph itself, weakly)."""
    jtri._TRIPLET_CACHE.clear()
    yield
    jtri._TRIPLET_CACHE.clear()


def _same(tensor, jarr, name=""):
    want = np.asarray(jarr)
    got = tensor.numpy()
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _ascending(idx_ji) -> bool:
    a = np.asarray(idx_ji)
    return bool((np.diff(a, axis=-1) >= 0).all())


# ---------------------------------------------------------------------------
# Indices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_quads", [False, True])
def test_build_triplets_matches_python_enumeration(seed, with_quads):
    """Random multigraphs with self-loops and isolated nodes, against the
    JAX package's loop (``_build_triplets_py``), index for index."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    ei = rng.integers(0, n, (2, int(rng.integers(0, 50)))).astype(np.int32)
    got = ttri.build_triplets(ei, n, with_quads)
    want = jtri._build_triplets_py(ei, n, with_quads)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert _ascending(got[4])


@pytest.mark.parametrize("with_quads", [False, True])
def test_star_graph_triplets_and_pad_sizes(with_quads):
    jg = jds.create_star_graphs(num=9, fold=(4, 5, 7), seed=1)
    tg = tds.create_star_graphs(num=9, fold=(4, 5, 7), seed=1)
    for a, b in zip(tg, jg):
        for x, y in zip(ttri.graph_triplets(a, with_quads),
                        jtri.graph_triplets(b, with_quads)):
            np.testing.assert_array_equal(x, y)
    assert ttri.graph_triplets(tg[0], with_quads) is ttri.graph_triplets(
        tg[0], with_quads)                      # cached per graph
    assert (ttri.triplet_pad_sizes(tg, 4, with_quads)
            == jtri.triplet_pad_sizes(jg, 4, with_quads))
    # a fold-7 star: 7 spokes x 6 other spokes, each with 6 candidate k_n
    seven = tds.create_star_graphs(num=1, fold=(7,), seed=0)[0]
    tri = ttri.build_triplets(seven.edge_index, seven.num_nodes, True)
    assert len(tri[0]) == 42 and len(tri[5]) == 252


@pytest.mark.parametrize("with_quads", [False, True])
def test_loader_batches_match_jax(with_quads):
    jg = jds.create_star_graphs(num=11, fold=(4, 5, 6), seed=2)
    tg = tds.create_star_graphs(num=11, fold=(4, 5, 6), seed=2)
    pad = jgraph.pad_sizes(jg, 4)
    jl = jgraph.GraphLoader(jg, 4, shuffle=True, seed=3, pad=pad,
                            with_triplets=True, with_quads=with_quads)
    tl = tgraph.GraphLoader(tg, 4, shuffle=True, seed=3, pad=pad,
                            with_triplets=True, with_quads=with_quads)
    assert tl.triplet_pad == jl.triplet_pad
    n = 0
    for jb, tb in zip(jl, tl):
        for name in TRI + (QUAD if with_quads else ()):
            _same(getattr(tb.triplets, name), getattr(jb.triplets, name), name)
        if not with_quads:
            assert tb.triplets.q_trip is None
        assert _ascending(tb.triplets.idx_ji)
        moved = tb.to("cpu")
        assert torch.equal(moved.triplets.idx_ji, tb.triplets.idx_ji)
        n += 1
    assert n == 3


@pytest.mark.parametrize("with_quads", [False, True])
def test_slot_triplets_round_trip_matches_jax(with_quads):
    jg = jds.create_star_graphs(num=13, fold=(3, 5, 6), seed=4)
    tg = tds.create_star_graphs(num=13, fold=(3, 5, 6), seed=4)
    jslot = jgraph.build_slot_data(jg, with_triplets=True,
                                   with_quads=with_quads)
    tslot = tgraph.build_slot_data(tg, with_triplets=True,
                                   with_quads=with_quads)
    names = ["tri_i", "tri_j", "tri_k", "tri_kj", "tri_ji", "tri_mask"]
    if with_quads:
        names += ["q_trip", "q_kn", "q_mask"]
    for name in names:
        _same(getattr(tslot, name), getattr(jslot, name), name)
    assert _ascending(tslot.tri_ji)
    rows = np.array([5, 13, 0, 12, 13, 2], np.int32)   # 13: the sentinel
    jb = jgraph.assemble_batch(jslot, jnp.asarray(rows))
    tb = tgraph.assemble_batch(tslot, torch.from_numpy(rows))
    for name in TRI + (QUAD if with_quads else ()):
        _same(getattr(tb.triplets, name), getattr(jb.triplets, name), name)
    assert _ascending(tb.triplets.idx_ji)


def test_attach_triplets_maps_real_edges_back_ascending():
    """A batch with pad edges between graphs' edges would reorder nothing:
    ``real`` is ascending, so ``idx_ji`` stays ascending; against JAX."""
    jg = jds.create_star_graphs(num=5, fold=(4, 6), seed=5)
    tg = tds.create_star_graphs(num=5, fold=(4, 6), seed=5)
    pad = jgraph.pad_sizes(jg, 5)
    jb = next(iter(jgraph.GraphLoader(jg, 5, pad=pad)))
    tb = next(iter(tgraph.GraphLoader(tg, 5, pad=pad)))
    # mask a few real edges off: they drop out of the triplets
    em = np.asarray(jb.edge_mask).copy()
    em[[1, 7, 20]] = False
    jb = jb.replace(edge_mask=jnp.asarray(em))
    tb.edge_mask = torch.from_numpy(em)
    for with_quads in (False, True):
        ja = jtri.attach_triplets(jb, with_quads=with_quads)
        ta = ttri.attach_triplets(tb, with_quads=with_quads)
        for name in TRI + (QUAD if with_quads else ()):
            _same(getattr(ta.triplets, name), getattr(ja.triplets, name), name)
        assert _ascending(ta.triplets.idx_ji)
        live = ta.triplets.idx_ji[ta.triplets.t_mask].numpy()
        assert em[live].all()


def test_triplet_cache_keeps_no_graph_alive(monkeypatch):
    """The cache empties once its graphs are freed and collected, and a new
    graph (at a reused id or not) gets its own triplets."""
    cache = weakref.WeakKeyDictionary()
    monkeypatch.setattr(ttri, "_TRIPLET_CACHE", cache)
    graphs = tds.create_star_graphs(num=6, fold=(4, 5), seed=8)
    for g in graphs:
        ttri.graph_triplets(g, False)
        ttri.graph_triplets(g, True)
    assert len(cache) == 6
    probe = weakref.ref(graphs[0])
    old_id, old = id(graphs[0]), ttri.graph_triplets(graphs[0], True)
    del g, graphs
    gc.collect()
    assert probe() is None and len(cache) == 0
    for seed in range(20):        # CPython hands a freed slot out again
        new = tds.create_star_graphs(num=1, fold=(7,), seed=seed)[0]
        if id(new) == old_id:
            break
    got = ttri.graph_triplets(new, True)
    want = ttri.build_triplets(new.edge_index, new.num_nodes, True)
    assert len(got) == len(want) and len(got[0]) != len(old[0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(cache) == 1
    # a graph type without weak references (the JAX package's) is served
    # and not cached
    jg = jds.create_star_graphs(num=1, fold=[5], seed=3)[0]
    for a, b in zip(ttri.graph_triplets(jg, False),
                    ttri.build_triplets(jg.edge_index, jg.num_nodes)):
        np.testing.assert_array_equal(a, b)
    assert len(cache) == 1


def test_builders_reject_unsorted_idx_ji(monkeypatch):
    graphs = tds.create_star_graphs(num=3, fold=(4,), seed=6)
    real = ttri.build_triplets

    def reversed_triplets(edge_index, num_nodes, with_quads=False):
        return tuple(a[::-1].copy() for a in real(edge_index, num_nodes,
                                                  with_quads))

    monkeypatch.setattr(ttri, "build_triplets", reversed_triplets)
    monkeypatch.setattr(ttri, "_TRIPLET_CACHE", {})
    with pytest.raises(ValueError, match="not ascending"):
        tgraph.build_slot_data(graphs, with_triplets=True)
    with pytest.raises(ValueError, match="not ascending"):
        next(iter(tgraph.GraphLoader(graphs, 3, with_triplets=True)))
    batch = next(iter(tgraph.GraphLoader(graphs, 3)))
    with pytest.raises(ValueError, match="not ascending"):
        ttri.attach_triplets(batch)
    with pytest.raises(ValueError, match="not ascending"):
        tgraph.check_ascending(np.array([0, 2, 1]), "here")


# ---------------------------------------------------------------------------
# The triplet fold's plan and the segment reductions
# ---------------------------------------------------------------------------


def test_ascending_plan_is_the_identity_csr_and_folds_masked_rows():
    rng = np.random.default_rng(7)
    ids = np.sort(rng.integers(0, 40, 300))
    ids[-20:] = 49                        # pad rows on the last segment
    mask = np.ones(300, bool)
    mask[-20:] = False
    mask[rng.integers(0, 280, 15)] = False
    plan = sss.ascending_plan(torch.from_numpy(ids.astype(np.int32)), 50)
    assert plan.identity_perm and plan.perm is None and not plan.masked
    np.testing.assert_array_equal(plan.rowptr.numpy(),
                                  np.searchsorted(ids, np.arange(51)))
    data = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    data.requires_grad_(True)
    out = sss.sorted_fold(data, torch.from_numpy(ids), plan,
                          torch.from_numpy(mask))
    want = jscatter.segment_sum(jnp.asarray(data.detach().numpy()),
                                jnp.asarray(ids), 50, mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    assert not out[40:49].any()           # empty segments give 0
    out.sum().backward()
    np.testing.assert_array_equal(data.grad.numpy()[:, 0], mask.astype(np.float32))


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_into_matches_jax(masked):
    rng = np.random.default_rng(8)
    acc = rng.standard_normal((30, 5)).astype(np.float32)
    data = rng.standard_normal((90, 5)).astype(np.float32)
    ids = rng.integers(0, 30, 90)
    mask = rng.random(90) > 0.3 if masked else None
    want = jscatter.segment_sum_into(jnp.asarray(acc), jnp.asarray(data),
                                     jnp.asarray(ids),
                                     None if mask is None else jnp.asarray(mask))
    tm = None if mask is None else torch.from_numpy(mask)
    got = tscatter.segment_sum_into(torch.from_numpy(acc),
                                    torch.from_numpy(data),
                                    torch.from_numpy(ids), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # through an ascending plan (the chunked fold): the same sums
    order = np.argsort(ids, kind="stable")
    sids = torch.from_numpy(ids[order])
    plan = sss.ascending_plan(sids, 30)
    got_p = tscatter.segment_sum_into(
        torch.from_numpy(acc), torch.from_numpy(data[order]), sids,
        None if mask is None else torch.from_numpy(mask[order]), plan=plan)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("fn", ["segment_min", "segment_softmax"])
@pytest.mark.parametrize("shape", [(60,), (60, 3)])
def test_segment_min_and_softmax_match_jax(fn, shape):
    rng = np.random.default_rng(9)
    data = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, 25, shape[0])     # some of the 25 segments empty
    ids[ids == 3] = 4
    mask = rng.random(shape[0]) > 0.25
    want = getattr(jscatter, fn)(jnp.asarray(data), jnp.asarray(ids), 25,
                                 mask=jnp.asarray(mask))
    got = getattr(tscatter, fn)(torch.from_numpy(data), torch.from_numpy(ids),
                                25, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if fn == "segment_min":
        assert not got[3].any()             # empty segment -> 0


def test_safe_arctan2_value_and_gradient_at_origin():
    y = np.array([0.0, 0.3, -1.0, 0.0, 2e-13], np.float32)
    x = np.array([0.0, -0.5, 0.2, 1.0, -1e-13], np.float32)
    want = jnorms.safe_arctan2(jnp.asarray(y), jnp.asarray(x))
    gy, gx = jax.grad(lambda a, b: jnp.sum(jnorms.safe_arctan2(a, b)),
                      argnums=(0, 1))(jnp.asarray(y), jnp.asarray(x))
    ty = torch.from_numpy(y).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tnorms.safe_arctan2(ty, tx)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-7)
    assert got[0].item() == 0.0
    assert torch.isfinite(ty.grad).all() and torch.isfinite(tx.grad).all()
    assert ty.grad[0].item() == 1.0 and tx.grad[0].item() == 0.0
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-6)


# ---------------------------------------------------------------------------
# Bases
# ---------------------------------------------------------------------------

X = np.concatenate([[0.0, 1e-6, 1e-3, 0.05, 0.5], np.linspace(0.9, 6.5, 29),
                    [7.0, 9.5, 14.0, 20.0]]).astype(np.float32)


def test_bessel_tables_equal():
    for ns, nr in ((3, 3), (7, 6)):
        assert tbasis.bessel_zeros(ns, nr) == jbasis.bessel_zeros(ns, nr)
        assert (tbasis.bessel_normalizers(ns, nr)
                == jbasis.bessel_normalizers(ns, nr))
        assert tbasis._legendre_tilde(ns) == jbasis._legendre_tilde(ns)


@pytest.mark.parametrize("l", range(7))
def test_spherical_bessel_matches_jax_with_finite_gradient_at_zero(l):
    want = jbasis.spherical_bessel_jl(l, jnp.asarray(X))
    jgrad = jax.grad(lambda v: jnp.sum(jbasis.spherical_bessel_jl(l, v)))(
        jnp.asarray(X))
    x = torch.from_numpy(X).requires_grad_(True)
    got = tbasis.spherical_bessel_jl(l, x)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("zero_outside", [False, True])
def test_dist_emb_and_radial_basis_match_jax(zero_outside):
    dist = np.concatenate([[0.0], X[1:] * 0.6]).astype(np.float32)  # 0: pad
    jm = jbasis.DistEmb(5, 4.0, 5, zero_outside=zero_outside)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(dist))
    want = jm.apply(v, jnp.asarray(dist))
    tm = tbasis.DistEmb(5, 4.0, 5, zero_outside=zero_outside)
    np.testing.assert_array_equal(tm.freq.detach().numpy(),
                                  np.asarray(v["params"]["freq"]))
    d = torch.from_numpy(dist).requires_grad_(True)
    got = tm(d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tbasis.sph_bessel_rbf(torch.from_numpy(dist), 4, 3, 4.0).numpy(),
        np.asarray(jbasis.sph_bessel_rbf(jnp.asarray(dist), 4, 3, 4.0)),
        atol=ATOL, rtol=RTOL)
    got.sum().backward()
    assert torch.isfinite(tm.freq.grad).all()


def test_angular_bases_and_embeddings_match_jax():
    rng = np.random.default_rng(10)
    t, e, ns, nr = 40, 25, 4, 3
    angle = np.concatenate([[0.0, np.pi], rng.uniform(0, np.pi, t - 2)]
                           ).astype(np.float32)
    phi = np.concatenate([[0.0, 2 * np.pi], rng.uniform(0, 2 * np.pi, t - 2)]
                         ).astype(np.float32)
    dist = np.concatenate([[0.0], rng.uniform(0.2, 5.0, e - 1)]
                          ).astype(np.float32)
    idx_kj = rng.integers(0, e, t)
    ta, tp, td = map(torch.from_numpy, (angle, phi, dist))
    ja, jp, jd = map(jnp.asarray, (angle, phi, dist))
    pairs = [
        (tbasis.angle_cbf(ta, ns), jbasis.angle_cbf(ja, ns)),
        (tbasis.torsion_cbf(ta, tp, ns), jbasis.torsion_cbf(ja, jp, ns)),
        (tbasis.angle_emb(td, ta, torch.from_numpy(idx_kj), ns, nr, 5.0),
         jbasis.AngleEmb(ns, nr, 5.0).apply({}, jd, ja, jnp.asarray(idx_kj))),
        (tbasis.torsion_emb(td, ta, tp, torch.from_numpy(idx_kj), ns, nr, 5.0),
         jbasis.TorsionEmb(ns, nr, 5.0).apply({}, jd, ja, jp,
                                              jnp.asarray(idx_kj))),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
