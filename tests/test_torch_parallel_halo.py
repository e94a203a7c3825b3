"""The port's graph partitioning (``parallel/halo.py``,
``parallel/partition.py`` and the differentiable all-to-all, all-gather
and reduce-scatter of ``parallel/mesh.py``) against the JAX package's
``halo.py`` and ``partition.py``: the host-side plan and Morton results
bitwise at k 2, 4 and 8; the device-side rounds (v0, packed, packed with
the overlap, ``gp_egnn_layer``) on 4 gloo CPU ranks against JAX's
single-device ``segment_sum`` and ``EGNNLayer`` at the JAX tests' sizes
(``tests/test_parallel.py``), atol 1e-5 (2e-5 for the EGNN layer, JAX's
own); every gradient through a collective against single-process autograd
of the same sums, atol 1e-5.  JAX is imported inside the tests only, so a
rank imports none of it; one launch of 4 ranks runs every device part."""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu_torch.models.egnn import EGNNLayer
from geometric_message_passing_tpu_torch.parallel import (
    build_halo_plan, differentiable, gp_edge_aggregate, gp_egnn_layer,
    gp_local_batch, gp_rank_batch, halo_stats, launch, make_mesh,
    morton_partition_graph, packed_halo_aggregate,
    packed_halo_aggregate_overlapped)
from geometric_message_passing_tpu_torch.parallel.halo import PLAN_ARRAYS
from geometric_message_passing_tpu_torch.ops.scatter import segment_sum

K = 4
TIMEOUT = 120
ATOL = 1e-5


def _random_graph(seed, n, e, drop):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, 16)).astype(np.float32)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    return h, snd, rcv, rng.random(e) > drop


# the JAX tests' graphs: (seed, nodes, edges, dropped share)
CASES = {"v0": (0, 64, 256, 0.1), "packed": (0, 32, 120, 0.1),
         "overlapped": (3, 32, 150, 0.15)}
SCALE = {"v0": 0.5, "packed": 0.5, "overlapped": 0.25}


def _msg(name):
    s = SCALE[name]
    if name == "v0":
        return lambda t, u: t * s + u
    return lambda t, u: t * s + torch.tanh(u)


def _box(n_nodes=640, k=K, seed=0):
    """The JAX box tests' Morton-partitioned box as one padded batch, its
    node rows a multiple of ``k``."""
    g = tds.create_molecular_boxes(num=1, n_nodes=n_nodes, cutoff=2.5,
                                   avg_degree=8, n_species=4, seed=seed)[0]
    g = morton_partition_graph(g)
    n_pad, e_pad, g_pad = pad_sizes([g], 1)
    return batch_graphs([g], -(-n_pad // k) * k, e_pad, g_pad)


def _egnn_case():
    rng = np.random.default_rng(7)
    n, d, e = K * 8, 16, 140
    h = rng.normal(size=(n, d)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    return h, pos, snd, rcv, rng.random(e) > 0.1


def _weights(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _block(x, rank, k=K):
    n = x.shape[0] // k
    return x[rank * n:(rank + 1) * n]


def _halo_rank(egnn_sd: dict) -> dict:
    """Every device-side part on one of 4 ranks."""
    mesh = make_mesh((K,), ("gp",), device="cpu")
    me = mesh.coords["gp"]
    out = {}
    for name, case in CASES.items():
        h, snd, rcv, emask = _random_graph(*case)
        h_loc = torch.from_numpy(_block(h, me)).requires_grad_()
        if name == "v0":
            res = gp_edge_aggregate(
                h_loc, torch.from_numpy(snd.reshape(K, -1)[me]),
                torch.from_numpy(rcv.reshape(K, -1)[me]),
                torch.from_numpy(emask.reshape(K, -1)[me]), _msg(name),
                h.shape[0], mesh)
        else:
            plan = build_halo_plan(snd, rcv, h.shape[0], K, edge_mask=emask)
            fn = (packed_halo_aggregate if name == "packed"
                  else packed_halo_aggregate_overlapped)
            res = fn(h_loc, plan.local(me), _msg(name), mesh)
        (res * _weights(10 + me, res.shape)).sum().backward()
        out[name] = (res.detach().numpy().copy(), h_loc.grad.numpy().copy())

    # the overlapped round on the Morton box (interior-dominated)
    box = _box()
    n = box.num_nodes
    h = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    plan = build_halo_plan(box.senders.numpy(), box.receivers.numpy(), n, K,
                           edge_mask=box.edge_mask.numpy())
    out["box"] = packed_halo_aggregate_overlapped(
        torch.from_numpy(_block(h, me)), plan.local(me),
        lambda t, u: 0.5 * t + u, mesh).numpy().copy()

    # gp_egnn_layer with the JAX layer's weights
    h, pos, snd, rcv, emask = _egnn_case()
    layer = EGNNLayer(16, aggr="add", generator=torch.Generator())
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in egnn_sd.items()})
    plan = build_halo_plan(snd, rcv, h.shape[0], K, edge_mask=emask)
    upd, new_pos = gp_egnn_layer(layer, torch.from_numpy(_block(h, me)),
                                 torch.from_numpy(_block(pos, me)),
                                 plan.local(me), mesh)
    out["egnn"] = (upd.detach().numpy().copy(),
                   new_pos.detach().numpy().copy())

    # the three collectives' backward
    grads = {}
    x = _weights(20 + me, (K, 3, 2)).requires_grad_()
    (differentiable.all_to_all(mesh, x, "gp") * _weights(30 + me, (K, 3, 2))
     ).sum().backward()
    grads["all_to_all"] = x.grad.numpy().copy()
    x = _weights(20 + me, (3, 2)).requires_grad_()
    (differentiable.all_gather(mesh, x, "gp")
     * _weights(30 + me, (K * 3, 2))).sum().backward()
    grads["all_gather"] = x.grad.numpy().copy()
    x = _weights(20 + me, (K * 3, 2)).requires_grad_()
    (differentiable.reduce_scatter_sum(mesh, x, "gp")
     * _weights(30 + me, (3, 2))).sum().backward()
    grads["reduce_scatter_sum"] = x.grad.numpy().copy()
    out["grads"] = grads
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch.spawn(_halo_rank, K, backend="gloo", device="cpu",
                        init_file=str(tmp_path_factory.mktemp("halo")
                                      / "rendezvous"),
                        args=(_egnn_jax()[1],), timeout_s=TIMEOUT)


def _egnn_jax():
    """(JAX layer outputs, its weights in the port's names)."""
    import jax
    import jax.numpy as jnp

    from geometric_message_passing_tpu.models.egnn import EGNNLayer as JLayer
    from geometric_message_passing_tpu_torch.weights import (
        egnn_layer_from_jax)

    h, pos, snd, rcv, emask = (jnp.asarray(a) for a in _egnn_case())
    layer = JLayer(emb_dim=16, aggr="add")
    variables = layer.init(jax.random.PRNGKey(0), h, pos, snd, rcv, emask)
    ref = layer.apply(variables, h, pos, snd, rcv, emask)
    sd = egnn_layer_from_jax(jax.tree.map(np.asarray, variables["params"]))
    return ([np.asarray(r) for r in ref],
            {k: v.numpy() for k, v in sd.items()})


def _jax_sum(name):
    """JAX's single-device round on the whole graph."""
    import jax.numpy as jnp

    from geometric_message_passing_tpu.ops.scatter import segment_sum as jss

    h, snd, rcv, emask = _random_graph(*CASES[name])
    s = SCALE[name]
    t, u = jnp.asarray(h[rcv]), jnp.asarray(h[snd])
    msg = t * s + (u if name == "v0" else jnp.tanh(u))
    return np.asarray(jss(msg, jnp.asarray(rcv), h.shape[0],
                          mask=jnp.asarray(emask)))


def _torch_grad(name):
    """d(sum_r w_r . out_r)/dh on one process, the whole graph."""
    h, snd, rcv, emask = _random_graph(*CASES[name])
    ht = torch.from_numpy(h).requires_grad_()
    rcv_t = torch.from_numpy(rcv).long()
    out = segment_sum(_msg(name)(ht[rcv_t], ht[torch.from_numpy(snd).long()]),
                      rcv_t, h.shape[0], mask=torch.from_numpy(emask))
    w = torch.cat([_weights(10 + r, (h.shape[0] // K, 16)) for r in range(K)])
    (out * w).sum().backward()
    return ht.grad.numpy()


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_plan_matches_jax_bitwise(k, masked):
    """Every ``HaloPlan`` array equal to JAX's ``build_halo_plan``'s
    (values, dtype, shape) on random graphs, with and without an edge
    mask."""
    from geometric_message_passing_tpu.parallel.halo import (
        build_halo_plan as jbuild)

    rng = np.random.default_rng(100 * k + masked)
    for n_local, e in ((1, 0), (3, 17), (8, 150), (11, 400)):
        n = k * n_local
        snd = rng.integers(0, n, e).astype(np.int32)
        rcv = rng.integers(0, n, e).astype(np.int32)
        emask = rng.random(e) > 0.2 if masked else None
        want = jbuild(snd, rcv, n, k, edge_mask=emask)
        got = build_halo_plan(snd, rcv, n, k, edge_mask=emask)
        assert got.n_local == want.n_local
        for name in PLAN_ARRAYS:
            a, b = got.local(0)[name], np.asarray(getattr(want, name))[0]
            full = getattr(got, name).numpy()
            assert full.dtype == np.asarray(getattr(want, name)).dtype, name
            np.testing.assert_array_equal(
                full, np.asarray(getattr(want, name)), err_msg=name)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_plan_and_stats_match_jax_on_a_morton_box():
    """On the Morton-partitioned 800-atom box at k 8 (the JAX box test's):
    every plan array and ``halo_stats`` equal JAX's, the packed exchange
    moves fewer bytes than the all-gather, ``gp_local_batch`` lays the
    edges out as JAX's and ``gp_rank_batch`` cuts it into the ranks'
    blocks."""
    from geometric_message_passing_tpu.parallel.halo import (
        build_halo_plan as jbuild, halo_stats as jstats)

    box = _box(800, k=8)
    args = (box.senders.numpy(), box.receivers.numpy(), box.num_nodes, 8)
    emask = box.edge_mask.numpy()
    want = jbuild(*args, edge_mask=emask)
    got = build_halo_plan(*args, edge_mask=emask)
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for dim in (36, 1024):
        st = halo_stats(got, dim, num_nodes=box.num_nodes)
        assert st == jstats(want, dim, num_nodes=box.num_nodes)
    assert st["wire_bytes"] < st["allgather_bytes"]
    assert int(got.int_mask.sum()) > int(got.bnd_mask.sum())
    local = gp_local_batch(box, got)      # JAX's layout of the edge fields
    for field, name in (("senders", "edge_src_cat"),
                        ("receivers", "edge_tgt_local"),
                        ("edge_mask", "edge_mask")):
        np.testing.assert_array_equal(
            getattr(local, field).numpy(),
            np.asarray(getattr(want, name)).reshape(-1))
    parts = [gp_rank_batch(box, got, r) for r in range(8)]
    for field in ("atoms", "pos", "senders", "edge_mask"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, field).numpy() for p in parts]),
            getattr(local, field).numpy())
    assert all(p.y is box.y for p in parts)


def test_plan_needs_node_rows_a_multiple_of_k():
    with pytest.raises(ValueError, match="multiple of k"):
        build_halo_plan(np.zeros(3, np.int32), np.zeros(3, np.int32), 10, 4)


@pytest.mark.parametrize("name", ["v0", "packed", "overlapped"])
def test_rounds_match_jax_single_device(ranks, name):
    """Each rank's block of the v0, packed and overlapped rounds against
    JAX's single-device gather -> message -> segment sum, and each rank's
    input gradient against single-process autograd of the weighted sums."""
    got = np.concatenate([r[name][0] for r in ranks])
    np.testing.assert_allclose(got, _jax_sum(name), atol=ATOL, rtol=0)
    grad = np.concatenate([r[name][1] for r in ranks])
    np.testing.assert_allclose(grad, _torch_grad(name), atol=ATOL, rtol=0)


def test_overlapped_round_on_the_morton_box(ranks):
    """The overlapped round on the box (most edges interior) against JAX's
    single-device sum."""
    import jax.numpy as jnp

    from geometric_message_passing_tpu.ops.scatter import segment_sum as jss

    box = _box()
    s, r = box.senders.numpy(), box.receivers.numpy()
    h = np.random.default_rng(0).normal(size=(box.num_nodes, 8)).astype(
        np.float32)
    want = jss(jnp.asarray(0.5 * h[r] + h[s]), jnp.asarray(r), box.num_nodes,
               mask=jnp.asarray(box.edge_mask.numpy()))
    got = np.concatenate([rk["box"] for rk in ranks])
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def test_gp_egnn_layer_matches_jax(ranks):
    """``gp_egnn_layer`` over 4 ranks against the JAX ``EGNNLayer`` on the
    whole graph (h update and the position mean), atol 2e-5."""
    (ref_h, ref_pos), _ = _egnn_jax()
    got_h = np.concatenate([r["egnn"][0] for r in ranks])
    got_pos = np.concatenate([r["egnn"][1] for r in ranks])
    np.testing.assert_allclose(got_h, ref_h, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_pos, ref_pos, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", ["all_to_all", "all_gather",
                                  "reduce_scatter_sum"])
def test_collective_gradients_match_single_process(ranks, name):
    """Each rank's gradient of sum_r w_r . f(x)_r against autograd of the
    same sum written on one process (the JAX transposes: the all-to-all
    its own, the all-gather's a reduce-scatter, the reduce-scatter's an
    all-gather)."""
    if name == "all_to_all":
        xs = [_weights(20 + r, (K, 3, 2)).requires_grad_() for r in range(K)]
        outs = [torch.stack([xs[p][q] for p in range(K)]) for q in range(K)]
        ws = [_weights(30 + q, (K, 3, 2)) for q in range(K)]
    elif name == "all_gather":
        xs = [_weights(20 + r, (3, 2)).requires_grad_() for r in range(K)]
        outs = [torch.cat(xs)] * K
        ws = [_weights(30 + q, (K * 3, 2)) for q in range(K)]
    else:
        xs = [_weights(20 + r, (K * 3, 2)).requires_grad_() for r in range(K)]
        total = sum(xs)
        outs = [total[3 * q:3 * (q + 1)] for q in range(K)]
        ws = [_weights(30 + q, (3, 2)) for q in range(K)]
    sum((o * w).sum() for o, w in zip(outs, ws)).backward()
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["grads"][name], xs[r].grad.numpy(),
                                   atol=ATOL, rtol=0)
