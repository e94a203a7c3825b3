"""DimeNet++'s and SphereNet's schedule options in the port: ``edge_chunk``,
``remat_blocks``, ``remat_full_blocks``, ``rbf_in_chunk`` and
``chunk_output_blocks=False`` (``models/dimenet.py``), and the checkpointed
triplet and quad chunks (both models).

Against the JAX package: its toy setting (4 star graphs, 2 layers, hidden
16, chunks of 100 that do not divide E or T) for the three option sets of
its own test, ``remat_full_blocks``, ``chunk_output_blocks=False`` and
``remat_blocks`` alone; the same weights in both (a JAX tree built with the
options, loaded by ``weights.dimenet_from_jax``), output and every
gradient.  Against the port's unchunked model: the same sets and one whose
chunks cut the live rows (edge chunks of 20, triplet chunks of 30), the
state dict's keys unchanged, and fewer bytes kept for the backward (a
saved-tensor hook that counts each storage once).  Per-row stages run in edge chunks are
bitwise the single pass (on the CPU where a chunk's elements fill whole
vector blocks of the CPU's loops: chunk x width a multiple of 64, as here),
and a checkpointed chunk's recompute is bitwise its forward: the gradients
with the checkpoint equal those without it.  DimeNet++ checkpoints its
triplet chunks only with ``edge_chunk``, ``remat_blocks`` or
``remat_full_blocks``; SphereNet always.

Tolerances (``test_torch_dimenet.py``'s): outputs 1e-5 absolute / 1e-4
relative (f32 sums in another order), gradients 2e-4 of max(|ref|, 1) per
parameter."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu import triplets as jtri
from geometric_message_passing_tpu.models import dimenet as jdimenet
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import (bench_scale,
                                                             profile_box)
from geometric_message_passing_tpu_torch.models import dimenet, spherenet
from geometric_message_passing_tpu_torch.ops.dimenet_basis import sph_bessel_rbf
from geometric_message_passing_tpu_torch.weights import dimenet_from_jax

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = 2e-4
JAX_KW = dict(num_layers=2, hidden_channels=16, int_emb_size=8,
              basis_emb_size=4, out_emb_channels=16, out_dim=1)
OPTIONS = [
    dict(edge_chunk=100, triplet_chunk=100),
    dict(edge_chunk=100, triplet_chunk=100, rbf_in_chunk=True),
    dict(edge_chunk=100, triplet_chunk=100, rbf_in_chunk=True,
         remat_blocks=True),
    dict(edge_chunk=100, triplet_chunk=100, remat_full_blocks=True),
    dict(edge_chunk=100, triplet_chunk=100, chunk_output_blocks=False),
    dict(edge_chunk=20, triplet_chunk=30, rbf_in_chunk=True,
         remat_blocks=True),
    dict(remat_blocks=True),
]
# against the JAX package: all but the fine-chunked set (chunks of 100 cut
# the toy batch's live rows too, and the JAX model is slow to trace)
JAX_OPTIONS = OPTIONS[:5] + OPTIONS[6:]
SPHERE_KW = dict(num_layers=2, hidden_channels=16, int_emb_size=8,
                 basis_emb_size_dist=4, basis_emb_size_angle=4,
                 basis_emb_size_torsion=4, out_emb_channels=16,
                 num_spherical=3, num_radial=3, num_output_layers=1,
                 out_dim=1)


@pytest.fixture(autouse=True)
def fresh_jax_triplet_cache():
    """The JAX package's triplet cache keys on ``id(graph)`` without holding
    the graph: start each test with it empty."""
    jtri._TRIPLET_CACHE.clear()
    yield
    jtri._TRIPLET_CACHE.clear()


def _batches(graphs, batch_size, quads=False):
    pad = jgraph.pad_sizes(graphs, batch_size)
    kw = dict(pad=pad, with_triplets=True, with_quads=quads)
    return (next(iter(jgraph.GraphLoader(graphs, batch_size, **kw))),
            next(iter(tgraph.GraphLoader(graphs, batch_size, **kw))))


def _toy():
    return _batches(tds.create_star_graphs(num=4, fold=(5, 6), seed=0), 4)


def _random_heads(params, seed=1):
    """The JAX parameters with each output block's last (zero) Dense
    drawn, so that every gradient is exercised."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for name, block in params.items():
        if name.startswith("output_"):
            last = max(block, key=lambda k: int(k.rsplit("_", 1)[1]))
            shape = block[last]["kernel"].shape
            block[last]["kernel"] = rng.normal(0, 0.5, shape).astype(np.float32)
    return params


def _grads(model, tb, c):
    model.zero_grad(set_to_none=True)
    out = model(tb)
    (out * torch.from_numpy(c)).sum().backward()
    return out.detach(), {n: p.grad.clone() for n, p in
                          model.named_parameters() if p.grad is not None}


def _assert_close(out, want_out, grads, want_grads, what):
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL,
                               rtol=RTOL, err_msg=what)
    assert set(grads) == set(want_grads), what
    for name, ref in want_grads.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            grads[name].numpy(), ref, err_msg=f"{what} {name}",
            atol=GRAD_REL * max(np.abs(ref).max(), 1.0))


def saved_bytes(fn) -> int:
    """Bytes of the distinct storages that ``fn()``'s autograd graph keeps
    for its backward (each storage counted once; a checkpoint's own hook
    takes its body's tensors, so they do not show), then backward."""
    kept = {}

    def pack(t):
        st = t.untyped_storage()
        kept[st.data_ptr()] = (st.nbytes(), t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    total = sum(n for n, _ in kept.values())
    out.backward()
    return total


@pytest.mark.parametrize("option", JAX_OPTIONS, ids=str)
def test_options_match_jax(option):
    """The port with ``option`` against the JAX model with it, from one JAX
    tree that was built with the options: ``dimenet_from_jax`` loads it
    into the port strictly, so its structure is the unchunked model's."""
    jb, tb = _toy()
    jmodel = jdimenet.DimeNetPPModel(**JAX_KW, **option)
    params = _random_heads(jmodel.init(jax.random.PRNGKey(0), jb)["params"])
    tmodel = dimenet.DimeNetPPModel(**JAX_KW, **option, device="cpu")
    tmodel.load_state_dict(dimenet_from_jax({"params": params}), strict=True)
    c = np.random.default_rng(2).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)

    def loss(p):
        out = jmodel.apply({"params": p}, jb)
        return jnp.sum(out * c), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    out, got = _grads(tmodel, tb, c)
    want_grads = {k: v.numpy() for k, v in dimenet_from_jax(
        {"params": jax.tree.map(np.asarray, grads)}).items()}
    _assert_close(out, want, got, want_grads, str(option))


def _star_batch():
    """12 stars on folds 5-7: E 256 (131 live), T 512."""
    return _batches(tds.create_star_graphs(num=12, fold=(5, 6, 7), seed=3),
                    12)[1]


def _drawn(model, seed=4):
    with torch.no_grad():
        for out in model.outputs:
            out.lin.weight.normal_(0, 0.5,
                                   generator=torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("option", OPTIONS, ids=str)
def test_options_match_the_unchunked_model(option):
    """The port with ``option`` against its own unchunked model: output and
    gradients within the tolerance, the same state-dict keys, and fewer
    bytes kept for the backward."""
    tb = _star_batch()
    kw = dict(JAX_KW, num_spherical=4, num_radial=3)
    base = _drawn(dimenet.DimeNetPPModel(**kw, device="cpu"))
    model = dimenet.DimeNetPPModel(**kw, **option, device="cpu")
    assert list(model.state_dict()) == list(base.state_dict())
    model.load_state_dict(base.state_dict(), strict=True)
    c = np.random.default_rng(5).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)
    want, want_grads = _grads(base, tb, c)
    out, grads = _grads(model, tb, c)
    _assert_close(out, want.numpy(), grads,
                  {k: v.numpy() for k, v in want_grads.items()}, str(option))
    assert (saved_bytes(lambda: model(tb).sum())
            < saved_bytes(lambda: base(tb).sum()))


@pytest.mark.parametrize("chunk", [20, 100])
def test_per_row_stages_are_bitwise_the_single_pass(chunk):
    """``edge_chunked`` runs the interaction block's chains, the output
    gate and the per-chunk radial basis row for row as the single pass."""
    tb = _star_batch()
    model = dimenet.DimeNetPPModel(**JAX_KW, device="cpu")
    blk, out = model.interactions[0], model.outputs[0]
    e = tb.num_edges
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(e, 16, generator=gen)
    rbf = torch.randn(e, 6, generator=gen)
    x_ji, x_kj = blk.pre(x, rbf)
    assert len(dimenet.chunk_slices(e, chunk)) > 1
    for got, want in (
            (dimenet.edge_chunked(blk.pre, chunk, x, rbf), (x_ji, x_kj)),
            ((dimenet.edge_chunked(blk.post, chunk, x_ji, x_kj, x),),
             (blk.post(x_ji, x_kj, x),)),
            ((dimenet.edge_chunked(out.gate, chunk, x, rbf),),
             (out.gate(x, rbf),))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    dist = torch.rand(e, generator=gen) * 5
    idx = tb.triplets.idx_kj
    table = sph_bessel_rbf(dist, 7, 6, 10.0)[idx]
    rows = torch.cat([sph_bessel_rbf(dist[idx[s]], 7, 6, 10.0) for s in
                      dimenet.chunk_slices(idx.shape[0], chunk)])
    assert torch.equal(rows, table)


@pytest.mark.parametrize("option", [
    dict(triplet_chunk=30), dict(edge_chunk=20, triplet_chunk=30,
                                 rbf_in_chunk=True, remat_blocks=True),
    dict(edge_chunk=20, triplet_chunk=30, remat_full_blocks=True),
    dict(triplet_chunk=30, remat_blocks=True)], ids=str)
def test_recompute_is_bitwise_the_forward(monkeypatch, option):
    """Every checkpoint's recompute gives bitwise the values its forward
    gave: the gradients with the checkpoints are those of the same schedule
    run without them."""
    tb = _star_batch()
    model = _drawn(dimenet.DimeNetPPModel(**JAX_KW, **option, device="cpu"))
    c = np.random.default_rng(7).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)
    out, grads = _grads(model, tb, c)
    monkeypatch.setattr(dimenet, "remat", lambda fn, *args: fn(*args))
    want, want_grads = _grads(model, tb, c)
    assert torch.equal(out, want)
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name


@pytest.mark.parametrize("option,checkpointed", [
    (dict(triplet_chunk=30), False),
    (dict(triplet_chunk=30, remat_blocks=True), True),
    (dict(triplet_chunk=30, edge_chunk=20), True),
    (dict(triplet_chunk=30, remat_full_blocks=True), True),
    (dict(remat_blocks=True), False)], ids=str)
def test_triplet_chunks_checkpointed_with_a_memory_schedule(
        monkeypatch, option, checkpointed):
    """The triplet chunks' rows go under checkpoint only where the schedule
    already trades time for memory (``edge_chunk``, ``remat_blocks`` or
    ``remat_full_blocks``) and there is more than one chunk; with
    ``triplet_chunk`` alone they are kept, as in the single pass."""
    tb = _star_batch()
    model = dimenet.DimeNetPPModel(**JAX_KW, **option, device="cpu")
    calls = []
    real = dimenet.remat

    def counting(fn, *args):
        if isinstance(fn, functools.partial) and fn.func.__name__ == "rows":
            calls.append(args[0])
        return real(fn, *args)

    monkeypatch.setattr(dimenet, "remat", counting)
    model(tb).sum().backward()
    assert bool(calls) == checkpointed
    if checkpointed:
        n = len(dimenet.chunk_slices(tb.triplets.num_triplets, 30))
        assert len(set(map(str, calls))) == n


def _sphere_batch():
    return _batches(tds.create_star_graphs(num=6, fold=(4, 5, 6), seed=0), 6,
                    quads=True)[1]


def test_spherenet_chunks_are_checkpointed(monkeypatch):
    """SphereNet's triplet chunks under checkpoint: the unchunked model's
    output and gradients, fewer bytes kept, and the recompute bitwise the
    forward."""
    tb = _sphere_batch()
    t, q = tb.triplets.num_triplets, tb.triplets.q_trip.shape[0]
    base = spherenet.SphereNetModel(**SPHERE_KW, device="cpu")
    model = spherenet.SphereNetModel(**SPHERE_KW, triplet_chunk=t // 3 - 1,
                                     quad_chunk=q // 4 - 1, device="cpu")
    model.load_state_dict(base.state_dict(), strict=True)
    c = np.random.default_rng(8).normal(size=(tb.num_graphs, 1)).astype(
        np.float32)
    want, want_grads = _grads(base, tb, c)
    out, grads = _grads(model, tb, c)
    _assert_close(out, want.numpy(), grads,
                  {k: v.numpy() for k, v in want_grads.items()}, "spherenet")
    assert (saved_bytes(lambda: model(tb).sum())
            < saved_bytes(lambda: base(tb).sum()))
    monkeypatch.setattr(spherenet, "remat", lambda fn, *args: fn(*args))
    monkeypatch.setattr(dimenet, "remat", lambda fn, *args: fn(*args))
    again, again_grads = _grads(model, tb, c)
    assert torch.equal(out, again)
    for name, g in again_grads.items():
        assert torch.equal(grads[name], g), name


def test_quad_chunks_are_checkpointed(monkeypatch):
    """Each quad slice's minimum under checkpoint: with the positions
    requiring a gradient, fewer bytes kept than the single pass, and the
    torsions and the positions' gradient bitwise those of the same slices
    without the checkpoint (the ``torch.minimum`` fold is exact)."""
    tb = _sphere_batch()
    q = tb.triplets.q_trip.shape[0]
    chunk = q // 4 - 1
    tb.pos = tb.pos.clone().requires_grad_()

    def torsion_and_grad(quad_chunk):
        tb.pos.grad = None
        torsion = spherenet.spherenet_geometry(tb, quad_chunk)[2]
        torsion.sum().backward()
        return torsion.detach(), tb.pos.grad.clone()

    torsion, grad = torsion_and_grad(chunk)
    assert (saved_bytes(lambda: spherenet.spherenet_geometry(tb, chunk)[2]
                        .sum())
            < saved_bytes(lambda: spherenet.spherenet_geometry(tb, None)[2]
                          .sum()))
    monkeypatch.setattr(spherenet, "remat", lambda fn, *args: fn(*args))
    want, want_grad = torsion_and_grad(chunk)
    assert torch.equal(torsion, want) and torch.equal(grad, want_grad)


@pytest.mark.parametrize("name", ["dimenet", "spherenet"])
def test_profile_box_parts_run_on_a_small_box(monkeypatch, name):
    """``profile_box.triplet_parts`` on a 300-atom box at the 100k rule's
    schedule (chunks a third of the edges and triplets), with the device
    timer replaced by a call: every part and its step count."""
    monkeypatch.setattr(profile_box, "part_device_ms",
                        lambda fn, iters=10: (fn(), 0.0)[1])
    box = bench_scale.kind_box(bench_scale.box_kind(name), 300)
    t = box.triplets.num_triplets
    if name == "dimenet":
        cfg = dict(bench_scale.config(name, 100_000), hidden_channels=16,
                   int_emb_size=8, out_emb_channels=16,
                   edge_chunk=box.num_edges // 3 + 1, triplet_chunk=t // 3 + 1)
        want = {"triplet_rows", "k3_fold", "edge_pre", "edge_post",
                "output_gate", "k4_chunk_sum"}
    else:
        cfg = dict(bench_scale.config(name, 10_000), hidden_channels=16,
                   int_emb_size=8, out_emb_channels=16,
                   triplet_chunk=t // 3 + 1,
                   quad_chunk=box.triplets.q_trip.shape[0] // 3 + 1)
        want = {"triplet_rows", "k3_fold", "geometry", "k4_update_v"}
    model = bench_scale.build(name, cfg, torch.Generator().manual_seed(0),
                              "cpu")
    parts = profile_box.triplet_parts(name, model, box, cfg)
    assert set(parts["parts"]) == want and parts["triplet_chunks"] == 3
    rows = parts["parts"]["triplet_rows"]
    assert rows["per_step"] == 4 * 3 and rows["remat"]
