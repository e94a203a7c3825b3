"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets, graph
from geometric_message_passing_tpu_torch.experiments import (
    bench_scale, bench_throughput, train)
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.models import (EGNNFusedModel,
                                                        GVPGNNModel, MACEModel,
                                                        TFNModel)
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops import edge_contract as ec
from geometric_message_passing_tpu_torch.ops import scatter
from geometric_message_passing_tpu_torch.ops import egnn_stack as es
from geometric_message_passing_tpu_torch.ops import gvp_message as gm
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

# f32 sums in another order (the kernel's K-loop and CSR rows against the
# plain version's matmuls and index_add_); the backward's weight gradient,
# a sum over all edges, to 1e-5 of its largest entry
ATOL = RTOL = 1e-4
W_REL = 1e-5


@pytest.fixture
def cuda_device():
    """The card, with TF32 off so the plain version is exact f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _inputs(n, e, d, seed, masked, index_dtype, device):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e) >= masked,
        rng.normal(size=(n, d)).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32),
        (rng.normal(size=(edge.msg_rows(d), d)) * 0.1).astype(np.float32),
    )
    send, recv, emask, h, pos, w = (torch.from_numpy(a).to(device)
                                    for a in arrays)
    return (send.to(index_dtype), recv.to(index_dtype), emask, h, pos, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d,masked,index_dtype", [
    (40, 150, 32, 0.1, torch.int32),
    (808, 1408, 128, 0.15, torch.int32),
    (10_000, 129_000, 128, 0.0, torch.int32),
    (17, 33, 16, 0.3, torch.int64),        # E not a multiple of the tile
    (50, 301, 256, 0.1, torch.int64),      # widest D: 82 KB of shared memory
    (6, 0, 48, 0.0, torch.int32),          # no edges
    # the resident kernel's plans: clusters of 1 (D 16, 64), 2 (112:
    # 56-column shares; 128; 144: 72), 4 (176) and 8 (240: shares of 32 and
    # 28; 256), below one tile, int32 and int64 ids, 10% of the edges masked
    (100, 700, 16, 0.1, torch.int32),
    (300, 1400, 64, 0.1, torch.int64),
    (90, 600, 112, 0.1, torch.int32),
    (808, 1408, 128, 0.1, torch.int64),
    (50, 5, 128, 0.1, torch.int32),
    (70, 900, 144, 0.1, torch.int32),
    (60, 500, 176, 0.1, torch.int64),
    (60, 500, 240, 0.1, torch.int32),
    (200, 4000, 256, 0.1, torch.int64),
    (20, 7, 256, 0.1, torch.int32),
])
def test_kernel_matches_plain(cuda_device, n, e, d, masked, index_dtype):
    args = _inputs(n, e, d, seed=8, masked=masked, index_dtype=index_dtype,
                   device=cuda_device)
    before = edge.egnn_message.launches
    with torch.no_grad():
        first = edge.egnn_message(*args)
        second = edge.egnn_message(*args)
        want = edge.egnn_message_plain(*args)
    torch.cuda.synchronize()
    assert edge.egnn_message.launches == before + 2
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)       # deterministic: no atomics
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_resident_plan_c_twin_matches(cuda_device):
    """The edge kernel's plan in C (gmp_egnn_resident_plan) equals
    ``edge.resident_plan`` at every width and a range of edge counts, and
    the card holds at least one cluster of every plan."""
    import ctypes
    from geometric_message_passing_tpu_torch.ops import _build
    lib = _build.load("egnn_message")
    out = (ctypes.c_int * 11)()
    for d in range(16, 257, 16):
        for e in (0, 5, 1400, 1408, 4193, 129_280):
            for clusters in (16, 66, 132):
                plan = edge.resident_plan(d, e, clusters)
                assert lib.gmp_egnn_resident_plan(d, e, clusters,
                                                  ctypes.addressof(out)) == 0
                got = (out[0], tuple(out[3:3 + out[0]]), out[1], out[2])
                assert got == tuple(plan)
        assert edge.kernel_resident_plan(1408, d, cuda_device)[1] >= 1
    assert lib.gmp_egnn_resident_plan(24, 100, 66, ctypes.addressof(out)) != 0


@pytest.mark.cuda
def test_kernel_raises_on_unsupported_width(cuda_device):
    args = _inputs(10, 20, 24, seed=0, masked=0.0, index_dtype=torch.int32,
                   device=cuda_device)
    with pytest.raises(ValueError):
        edge.egnn_message(*args)


@pytest.mark.cuda
def test_predictor_on_card_matches_cpu(cuda_device):
    graphs = datasets.create_star_graphs(num=30, fold=(4, 5, 6), seed=2)
    kw = dict(num_layers=2, emb_dim=32, in_dim=1, out_dim=2, pool="mean")
    gpu = EGNNFusedModel(**kw, generator=torch.Generator().manual_seed(1),
                         device=cuda_device)
    cpu = EGNNFusedModel(**kw, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    before = edge.egnn_message.launches
    y = Predictor(gpu, batch_size=8).predict(graphs)
    assert edge.egnn_message.launches == before + 4 * 2
    y_cpu = Predictor(cpu, batch_size=8, device="cpu").predict(graphs)
    np.testing.assert_allclose(y, y_cpu, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d,masked,index_dtype", [
    (40, 150, 32, 0.1, torch.int32),
    (800, 1400, 128, 0.15, torch.int32),   # the train bucket
    (17, 33, 16, 0.3, torch.int64),        # E not a multiple of the tile
    (50, 301, 256, 0.1, torch.int64),      # widest D
    (300, 1100, 64, 0.0, torch.int32),     # three weight-gradient slices
    (6, 0, 48, 0.0, torch.int32),          # no edges
])
def test_bwd_kernel_matches_plain(cuda_device, n, e, d, masked, index_dtype):
    args = _inputs(n, e, d, seed=9, masked=masked, index_dtype=index_dtype,
                   device=cuda_device)
    if e:
        args[1][:4] = args[0][:4]          # zero-length live edges
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    cot = (torch.randn((n, d), generator=gen, device=cuda_device),
           torch.randn((n, 3), generator=gen, device=cuda_device))
    before = edge.egnn_message.bwd_launches
    first = edge.egnn_message_bwd(*args, *cot)
    second = edge.egnn_message_bwd(*args, *cot)
    want = edge.egnn_message_bwd_plain(*args, *cot)
    torch.cuda.synchronize()
    assert edge.egnn_message.bwd_launches == before + 2
    for a, b, w, name in zip(first, second, want, ("dh", "dpos", "dW")):
        assert torch.equal(a, b), name     # deterministic: no atomics
        if name == "dW":
            torch.testing.assert_close(
                a, w, atol=W_REL * max(w.abs().max().item(), 1.0), rtol=0)
        else:
            torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_autograd_on_card_launches_bwd_kernel(cuda_device):
    args = _inputs(30, 90, 32, seed=10, masked=0.1, index_dtype=torch.int32,
                   device=cuda_device)
    send, recv, emask, h, pos, w = args
    leaves = [t.clone().requires_grad_() for t in (h, pos, w)]
    before = (edge.egnn_message.launches, edge.egnn_message.bwd_launches)
    msg, pos_sum, cnt = edge.egnn_message(send, recv, emask, *leaves)
    grads = torch.autograd.grad(msg.sum() + 2 * pos_sum.sum(), leaves)
    assert (edge.egnn_message.launches,
            edge.egnn_message.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = edge.egnn_message_bwd_plain(send, recv, emask, h, pos, w,
                                       torch.ones_like(h),
                                       torch.full_like(pos, 2.0))
    for g, w_ in zip(grads, want):
        torch.testing.assert_close(
            g, w_, atol=max(ATOL, W_REL * w_.abs().max().item()), rtol=RTOL)


@pytest.mark.cuda
def test_bwd_kernel_raises_on_bad_cotangent(cuda_device):
    args = _inputs(10, 20, 16, seed=0, masked=0.0, index_dtype=torch.int32,
                   device=cuda_device)
    with pytest.raises(ValueError):
        edge.egnn_message_bwd(*args, torch.zeros(10, 32, device=cuda_device),
                              torch.zeros(10, 3, device=cuda_device))


@pytest.mark.cuda
def test_two_train_steps_on_card_match_cpu(cuda_device):
    graphs = datasets.create_star_graphs(num=24, fold=(5, 6, 7), seed=4)
    kw = dict(num_layers=2, emb_dim=32, in_dim=1, out_dim=1, pool="first")
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = EGNNFusedModel(**kw, generator=torch.Generator().manual_seed(2),
                               device=dev)
        slot = graph.build_slot_data(graphs, device=dev)
        opt = train.make_tx(model.parameters(), 5e-4)
        losses = [train.train_step(model, opt, slot,
                                   torch.tensor(row, device=dev)).item()
                  for row in ([3, 1, 24, 7, 0, 12], [5, 9, 2, 24, 24, 11])]
        results[dev.type] = (losses, {k: v.cpu() for k, v in
                                      model.state_dict().items()})
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0],
                               rtol=1e-5)
    for key, value in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][key], value,
                                   atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The sorted segment sum (K3) and the segment sum over unsorted ids (K4)
# ---------------------------------------------------------------------------

# f32 sums of the same rows in another order (the plain version's
# index_add_ on the card uses atomics), the JAX test's own tolerance
SEG_TOL = 1e-5


def _seg_case(e, n, d, seed, masked, sort, device):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, e)
    if sort:
        seg = np.sort(seg)
    data = rng.standard_normal((e, d)).astype(np.float32)
    mask = rng.random(e) >= masked
    return (torch.from_numpy(data).to(device), torch.from_numpy(seg).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,d,masked,sort", [
    (3000, 700, 64, 0.1, False),
    (3000, 700, 64, 0.1, True),       # identity plan
    (5000, 128, 128, 0.0, True),
    (2000, 50, 4, 0.1, False),        # one thread per segment
    (2000, 50, 3, 0.1, True),
    (1500, 300, 1, 0.2, False),
    (700, 90, 130, 0.1, False),       # D % 4 != 0: scalar lanes
    (900, 40, 256, 0.1, False),       # two float4 column passes
    (1500, 300, 32, 1.0, False),      # all masked: every segment empty
    (0, 20, 16, 0.0, False),          # no edges
])
def test_sorted_segsum_kernel_matches_plain(cuda_device, e, n, d, masked, sort):
    data, seg, mask = _seg_case(e, n, d, 11, masked, sort, cuda_device)
    plan = sss.build_segment_plan(seg, n, mask=mask, device=cuda_device)
    if e and masked < 1.0:
        assert plan.identity_perm == (sort and masked == 0.0)
    before = sss.sorted_segment_sum.launches
    with torch.no_grad():
        first = sss.sorted_segment_sum(data, plan, seg, mask)
        second = sss.sorted_segment_sum(data, plan, seg, mask)
        want = sss.sorted_segment_sum_plain(data, seg, n, mask)
    torch.cuda.synchronize()
    assert sss.sorted_segment_sum.launches == before + 2
    assert torch.equal(first, second)          # no atomics: bitwise repeatable
    torch.testing.assert_close(first, want, atol=SEG_TOL, rtol=SEG_TOL)
    if masked == 1.0:
        assert torch.equal(first, torch.zeros_like(first))


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,d,masked", [(3000, 700, 64, 0.1),
                                          (2000, 50, 3, 0.0),
                                          (1500, 300, 32, 1.0)])
def test_segment_sum_kernel_matches_plain(cuda_device, e, n, d, masked):
    data, seg, mask = _seg_case(e, n, d, 12, masked, False, cuda_device)
    before = sss.segment_sum.launches
    with torch.no_grad():
        first = sss.segment_sum(data, seg.int(), n, mask)
        second = sss.segment_sum(data, seg, n, mask)
        want = sss.sorted_segment_sum_plain(data, seg, n, mask)
    torch.cuda.synchronize()
    assert sss.segment_sum.launches == before + 2
    assert torch.equal(first, second)
    torch.testing.assert_close(first, want, atol=SEG_TOL, rtol=SEG_TOL)


@pytest.mark.cuda
def test_sorted_gather_backward_launches_kernel(cuda_device):
    data, seg, mask = _seg_case(3000, 700, 64, 13, 0.1, False, cuda_device)
    h = torch.randn((700, 64), device=cuda_device, requires_grad=True)
    plan = sss.build_segment_plan(seg, 700, mask=mask, device=cuda_device)
    before = sss.sorted_segment_sum.launches
    out = sss.sorted_gather(h, seg, plan, mask)
    assert sss.sorted_segment_sum.launches == before    # a plain gather
    (dh,) = torch.autograd.grad((out * data).sum(), [h])
    assert sss.sorted_segment_sum.launches == before + 1
    want = sss.sorted_segment_sum_plain(data, seg, 700, mask)
    torch.testing.assert_close(dh, want, atol=SEG_TOL, rtol=SEG_TOL)


@pytest.mark.cuda
def test_plan_on_another_device_raises(cuda_device):
    data, seg, mask = _seg_case(300, 70, 8, 14, 0.1, False, cuda_device)
    plan = sss.build_segment_plan(seg, 70, mask=mask, device="cpu")
    with pytest.raises(ValueError):
        sss.sorted_segment_sum(data, plan, seg, mask)
    with pytest.raises(ValueError):
        sss.sorted_gather(torch.zeros((70, 8), device=cuda_device), seg, plan,
                          mask)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["egnn_sorted", "schnet_sorted"])
def test_two_box_adam_steps_on_card_match_cpu(cuda_device, name):
    cfg = dict(num_layers=2, emb_dim=32) if name == "egnn_sorted" else \
        dict(num_layers=2, hidden_channels=32, num_filters=32)
    host = bench_scale.box_batch(400, sort=True)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        batch = host.to(dev)
        model = bench_scale.build(name, cfg, torch.Generator().manual_seed(3),
                                  dev)
        plans = sss.batch_seg_plans(batch)
        step = bench_scale.make_step(model, batch, plans)
        before = sss.sorted_segment_sum.launches
        losses = [step().item() for _ in range(2)]
        launches = sss.sorted_segment_sum.launches - before
        results[dev.type] = (losses, launches, {k: v.cpu() for k, v in
                                                model.state_dict().items()})
    per_step = bench_scale.sorted_launches_per_step(name, 2)
    assert per_step == {"egnn_sorted": 10, "schnet_sorted": 4}[name]
    assert results["cuda"][1] == 2 * per_step
    assert results["cpu"][1] == 0
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-5)
    for key, value in results["cpu"][2].items():
        torch.testing.assert_close(results["cuda"][2][key], value,
                                   atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The GVP message pass (K5 forward and backward)
# ---------------------------------------------------------------------------


def _gvp_inputs(n, e, node_dims, edge_dims, n_layers, seed, masked,
                index_dtype, device, zero_vectors=False):
    """Node and edge features, indices, mask and chain weights (the JAX
    test's scales); ``zero_vectors``: node vectors all zero, as layer 0 of
    the model gets them from ``W_v``."""
    rng = np.random.default_rng(seed)
    (S, V), (SE, VE) = node_dims, edge_dims
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    nodes = [f(n, S)] + [f(n, V) * (0.0 if zero_vectors else 1.0)
                         for _ in range(3)]
    edges = [f(e, SE)] + [f(e, VE) for _ in range(3)]
    dims = [(2 * S + SE, 2 * V + VE)] + [tuple(node_dims)] * n_layers
    ws = []
    for k in range(n_layers):
        (si, vi), (so, vo) = dims[k], dims[k + 1]
        h = max(vi, vo)
        ws += [f(vi, h) * 0.2, f(h, vo) * 0.2, f(si + h, so) * 0.1,
               f(so) * 0.1, f(so, vo) * 0.1, f(vo) * 0.1]
    send, recv = rng.integers(0, n, e), rng.integers(0, n, e)
    recv[:3] = send[:3]                       # zero-length live edges
    emask = rng.random(e) >= masked
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ((to(send).to(index_dtype), to(recv).to(index_dtype), to(emask)),
            [to(a) for a in nodes], [to(a) for a in edges], [to(w) for w in ws])


GVP_CASES = [
    (40, 150, (16, 4), (8, 1), 3, 0.15, torch.int32, False),
    (20, 70, (12, 4), (6, 1), 3, 0.15, torch.int64, False),
    (30, 90, (16, 4), (8, 1), 1, 0.1, torch.int32, False),
    (808, 1408, (128, 16), (32, 1), 3, 0.15, torch.int32, True),  # full width
    (300, 1100, (64, 8), (16, 2), 2, 0.0, torch.int32, False),    # 3 slices
    (17, 33, (5, 3), (3, 2), 2, 0.3, torch.int64, False),         # ragged widths
    (6, 0, (16, 4), (8, 1), 3, 0.0, torch.int32, False),          # no edges
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,node,edge_dims,layers,masked,index_dtype,zero",
                         GVP_CASES)
def test_gvp_kernel_matches_plain(cuda_device, n, e, node, edge_dims, layers,
                                  masked, index_dtype, zero):
    idx, nodes, edges, ws = _gvp_inputs(n, e, node, edge_dims, layers, 20,
                                        masked, index_dtype, cuda_device, zero)
    before = gm.gvp_message.launches
    with torch.no_grad():
        first = gm.gvp_message(*idx, *nodes, *edges, *ws)
        second = gm.gvp_message(*idx, *nodes, *edges, *ws)
        want = gm.gvp_message_plain(*idx, *nodes, *edges, ws, layers)
    torch.cuda.synchronize()
    assert gm.gvp_message.launches == before + 2
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)       # deterministic: no atomics
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)


# A ReLU pre-activation within f32 rounding of zero (~1e-6 for these sums of
# 144-321 products) may take its mask the other way in the kernel than in the
# plain version, and then that edge's cotangents differ by O(0.01):
# chip_smoke.py masks such edges off at its full-width shapes
# (``relu_margins``).  Here each case's seed keeps every pre-activation 5e-6
# from zero.
GVP_BWD_SEEDS = (21, 22, 21, 23, 20, 21, 21)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,node,edge_dims,layers,masked,index_dtype,zero,"
                         "seed", [c + (s,) for c, s in zip(GVP_CASES,
                                                           GVP_BWD_SEEDS)])
def test_gvp_bwd_kernel_matches_plain(cuda_device, n, e, node, edge_dims,
                                      layers, masked, index_dtype, zero, seed):
    idx, nodes, edges, ws = _gvp_inputs(n, e, node, edge_dims, layers, seed,
                                        masked, index_dtype, cuda_device, zero)
    margins = gm.relu_margins(*idx, nodes, edges, ws)
    assert margins.numel() == 0 or margins.min().item() > 5e-6
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    cots = [torch.randn((n, w), generator=gen, device=cuda_device)
            for w in (node[0],) + (node[1],) * 3]
    before = gm.gvp_message.bwd_launches
    first = gm.gvp_message_bwd(*idx, *nodes, *edges, ws, *cots)
    second = gm.gvp_message_bwd(*idx, *nodes, *edges, ws, *cots)
    want = gm.gvp_message_bwd_plain(*idx, *nodes, *edges, ws, *cots)
    torch.cuda.synchronize()
    assert gm.gvp_message.bwd_launches == before + 2
    for a, b, w in zip(first[:8], second[:8], want[:8]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    for a, b, w in zip(first[8], second[8], want[8]):
        assert torch.equal(a, b)
        torch.testing.assert_close(
            a, w, atol=W_REL * max(w.abs().max().item(), 1.0), rtol=0)


# K5's edge tile (``gvp_message.gvp_tile``) at its edges on 132 SMs: 8 up
# to 2096 edges, 16 from 2097, 32 from 4193 where its shared memory fits
# (the backward's does not at full width: 16 there)
GVP_TILE_CASES = [(600, 2096, (16, 4), (8, 1)), (600, 2097, (16, 4), (8, 1)),
                  (900, 4241, (16, 4), (8, 1)),
                  (2000, 4300, (128, 16), (32, 1))]   # full width


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,node,edge_dims", GVP_TILE_CASES)
def test_gvp_kernels_at_tile_edges(cuda_device, n, e, node, edge_dims):
    """K5 forward and backward against the plain versions where the tile
    rule changes its tile, bitwise repeatable.  Edges within 1e-5 of a ReLU
    flip are masked off (``relu_margins``), as ``chip_smoke.py`` does; the
    weight gradients, sums over up to 4300 edges in another order, within
    1e-4 of their largest entry."""
    idx, nodes, edges, ws = _gvp_inputs(n, e, node, edge_dims, 3, 24, 0.1,
                                        torch.int32, cuda_device,
                                        node[0] == 128)
    margins = gm.relu_margins(*idx, nodes, edges, ws)
    idx = (idx[0], idx[1], idx[2] & (margins > 1e-5))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cots = [torch.randn((n, w), generator=gen, device=cuda_device)
            for w in (node[0],) + (node[1],) * 3]
    with torch.no_grad():
        got = [gm.gvp_message(*idx, *nodes, *edges, *ws) for _ in range(2)]
        want = gm.gvp_message_plain(*idx, *nodes, *edges, ws, 3)
    grads = [gm.gvp_message_bwd(*idx, *nodes, *edges, ws, *cots)
             for _ in range(2)]
    wgrads = gm.gvp_message_bwd_plain(*idx, *nodes, *edges, ws, *cots)
    torch.cuda.synchronize()
    for a, b, w in zip(*got, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    for a, b, w in zip(grads[0][:8], grads[1][:8], wgrads[:8]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    for a, b, w in zip(grads[0][8], grads[1][8], wgrads[8]):
        assert torch.equal(a, b)
        torch.testing.assert_close(
            a, w, atol=1e-4 * max(w.abs().max().item(), 1.0), rtol=0)


@pytest.mark.cuda
def test_gvp_autograd_on_card_launches_bwd_kernel(cuda_device):
    idx, nodes, edges, ws = _gvp_inputs(30, 90, (16, 4), (8, 1), 3, 22, 0.1,
                                        torch.int32, cuda_device)
    leaves = [t.clone().requires_grad_() for t in nodes + edges + ws]
    before = (gm.gvp_message.launches, gm.gvp_message.bwd_launches)
    out = gm.gvp_message(*idx, *leaves)
    grads = torch.autograd.grad(out[0].sum() + 2 * out[2].sum(), leaves)
    assert (gm.gvp_message.launches,
            gm.gvp_message.bwd_launches) == (before[0] + 1, before[1] + 1)
    cots = [torch.ones_like(out[0]), torch.zeros_like(out[1]),
            torch.full_like(out[2], 2.0), torch.zeros_like(out[3])]
    want = gm.gvp_message_bwd_plain(*idx, *nodes, *edges, ws, *cots)
    for g, w_ in zip(grads, list(want[:8]) + list(want[8])):
        torch.testing.assert_close(
            g, w_, atol=max(ATOL, W_REL * w_.abs().max().item()), rtol=RTOL)


@pytest.mark.cuda
def test_gvp_kernel_raises_on_bad_widths(cuda_device):
    idx, nodes, edges, ws = _gvp_inputs(10, 20, (16, 4), (8, 1), 3, 0, 0.0,
                                        torch.int32, cuda_device)
    with pytest.raises(ValueError):     # a chain that does not fit the nodes
        gm.gvp_message(*idx, *nodes, *edges, *ws[6:])
    with pytest.raises(ValueError):     # a message row wider than 256
        wide = _gvp_inputs(10, 20, (250, 4), (8, 1), 1, 0, 0.0, torch.int32,
                           cuda_device)
        gm.gvp_message(*wide[0], *wide[1], *wide[2], *wide[3])


@pytest.mark.cuda
def test_gvp_model_on_card_matches_cpu(cuda_device):
    """Serving and two train steps of a small GVP-GNN over K5 (in eval mode,
    so without dropout: the two devices' generators differ)."""
    graphs = datasets.create_star_graphs(num=24, fold=(5, 6, 7), seed=4)
    kw = dict(num_layers=2, s_dim=32, v_dim=4, use_pallas=True)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = GVPGNNModel(**kw, generator=torch.Generator().manual_seed(2),
                            device=dev)
        before = gm.gvp_message.launches
        y = Predictor(model, batch_size=8, device=dev).predict(graphs)
        launched = gm.gvp_message.launches - before
        slot = graph.build_slot_data(graphs, device=dev)
        opt = train.make_tx(model.parameters(), 5e-4)
        model.eval()
        losses = [train.train_step(model, opt, slot,
                                   torch.tensor(row, device=dev)).item()
                  for row in ([3, 1, 23, 7, 0, 12], [5, 9, 2, 24, 24, 11])]
        results[dev.type] = (y, launched, losses,
                             {k: v.cpu() for k, v in model.state_dict().items()})
    assert results["cuda"][1] == 3 * 2 and results["cpu"][1] == 0
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(results["cuda"][2], results["cpu"][2], rtol=1e-5)
    for key, value in results["cpu"][3].items():
        torch.testing.assert_close(results["cuda"][3][key], value,
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_gvp_sorted_box_steps_on_card_match_cpu(cuda_device, remat):
    cfg = dict(num_layers=2, s_dim=32, v_dim=4, remat=remat)
    host = bench_scale.box_batch(400, sort=True)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        batch = host.to(dev)
        model = bench_scale.build("gvp_sorted", cfg,
                                  torch.Generator().manual_seed(3), dev).eval()
        step = bench_scale.make_step(model, batch, sss.batch_seg_plans(batch))
        before = (sss.sorted_segment_sum.launches, gm.gvp_message.launches)
        losses = [step().item() for _ in range(2)]
        launches = (sss.sorted_segment_sum.launches - before[0],
                    gm.gvp_message.launches - before[1])
        results[dev.type] = (losses, launches, {k: v.cpu() for k, v in
                                                model.state_dict().items()})
    per_step = bench_scale.sorted_launches_per_step("gvp_sorted", 2, remat)
    assert results["cuda"][1] == (2 * per_step, 0)
    assert results["cpu"][1] == (0, 0)
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-5)
    for key, value in results["cpu"][2].items():
        torch.testing.assert_close(results["cuda"][2][key], value,
                                   atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The whole EGNN stack (K6, forward and backward)
# ---------------------------------------------------------------------------


def _stack_inputs(n, e, d, n_layers, seed, masked, index_dtype, device):
    rng = np.random.default_rng(seed)
    send, recv = rng.integers(0, n, e), rng.integers(0, n, e)
    recv[:4] = send[:4]                    # zero-length live edges
    w = (rng.normal(size=(n_layers, es.stack_rows(d), d)) * 0.1).astype(np.float32)
    for row in (2 * d + 2, 3 * d + 5, 4 * d + 8, 6 * d + 13, 7 * d + 16):
        w[:, row, :] = 1.0                 # LayerNorm scales
    arrays = (send, recv, rng.random(e) >= masked,
              rng.normal(size=(n, d)).astype(np.float32),
              rng.normal(size=(n, 3)).astype(np.float32), w,
              rng.normal(size=(n, d)).astype(np.float32),
              rng.normal(size=(n, 3)).astype(np.float32))
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
    t[0], t[1] = t[0].to(index_dtype), t[1].to(index_dtype)
    return tuple(t[:6]), tuple(t[6:])


STACK_CASES = [
    (30, 110, 16, 3, 0.15, torch.int32),
    (800, 1400, 128, 4, 0.15, torch.int32),   # the star train bucket's size
    (17, 33, 16, 1, 0.3, torch.int64),        # E not a multiple of the tile
    (50, 301, 256, 2, 0.1, torch.int64),      # widest D
    (600, 1100, 32, 2, 0.0, torch.int32),     # three edge slices, two node slices
    (6, 0, 48, 2, 0.0, torch.int32),          # no edges
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,d,n_layers,masked,index_dtype", STACK_CASES)
def test_stack_kernels_match_plain(cuda_device, n, e, d, n_layers, masked,
                                   index_dtype):
    args, cot = _stack_inputs(n, e, d, n_layers, seed=11, masked=masked,
                              index_dtype=index_dtype, device=cuda_device)
    before = (es.egnn_stack.launches, es.egnn_stack.bwd_launches)
    with torch.no_grad():
        first, second = (es.egnn_stack(*args, n_layers) for _ in range(2))
    want = es.egnn_stack_plain(*args, n_layers)
    grads = [es.egnn_stack_bwd(*args, n_layers, *cot) for _ in range(2)]
    want_grads = es.egnn_stack_bwd_plain(*args, n_layers, *cot)
    torch.cuda.synchronize()
    # one launch per call and direction, whatever the layer count
    assert (es.egnn_stack.launches, es.egnn_stack.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)           # deterministic: no atomics
        torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)
    for a, b, w, name in zip(*grads, want_grads, ("dh0", "dpos0", "dW")):
        assert torch.equal(a, b), name
        if name == "dW":
            for layer in range(n_layers):
                torch.testing.assert_close(
                    a[layer], w[layer],
                    atol=W_REL * max(w[layer].abs().max().item(), 1.0), rtol=0)
        else:
            torch.testing.assert_close(a, w, atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_stack_autograd_on_card_launches_bwd_kernel(cuda_device):
    args, cot = _stack_inputs(40, 150, 32, 3, seed=12, masked=0.1,
                              index_dtype=torch.int32, device=cuda_device)
    send, recv, emask, h, pos, w = args
    leaves = [t.clone().requires_grad_() for t in (h, pos, w)]
    before = (es.egnn_stack.launches, es.egnn_stack.bwd_launches)
    ho, po = es.egnn_stack(send, recv, emask, *leaves, 3)
    grads = torch.autograd.grad((ho * cot[0]).sum() + (po * cot[1]).sum(), leaves)
    assert (es.egnn_stack.launches, es.egnn_stack.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want = es.egnn_stack_bwd_plain(*args, 3, *cot)
    for g, w_ in zip(grads, want):
        torch.testing.assert_close(
            g, w_, atol=max(ATOL, W_REL * w_.abs().max().item()), rtol=RTOL)


@pytest.mark.cuda
def test_stack_kernel_raises_on_unsupported_width(cuda_device):
    args, _ = _stack_inputs(10, 20, 24, 2, seed=0, masked=0.0,
                            index_dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        es.egnn_stack(*args, 2)


@pytest.mark.cuda
def test_two_stack_train_steps_on_card_match_cpu(cuda_device):
    graphs = datasets.create_star_graphs(num=24, fold=(5, 6, 7), seed=4)
    kw = dict(num_layers=3, emb_dim=32, in_dim=1, out_dim=1, pool="first",
              fuse_stack=True)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = EGNNFusedModel(**kw, generator=torch.Generator().manual_seed(2),
                               device=dev)
        slot = graph.build_slot_data(graphs, device=dev)
        opt = train.make_tx(model.parameters(), 5e-4)
        before = (es.egnn_stack.launches, es.egnn_stack.bwd_launches,
                  edge.egnn_message.launches, edge.egnn_message.bwd_launches)
        losses = [train.train_step(model, opt, slot,
                                   torch.tensor(row, device=dev)).item()
                  for row in ([3, 1, 24, 7, 0, 12], [5, 9, 2, 24, 24, 11])]
        launches = tuple(a - b for a, b in zip(
            (es.egnn_stack.launches, es.egnn_stack.bwd_launches,
             edge.egnn_message.launches, edge.egnn_message.bwd_launches), before))
        y = Predictor(model, batch_size=8, device=dev).predict(graphs)
        results[dev.type] = (losses, launches, y, {k: v.cpu() for k, v in
                                                   model.state_dict().items()})
    assert results["cuda"][1] == (2, 2, 0, 0)
    assert results["cpu"][1] == (0, 0, 0, 0)
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(results["cuda"][2], results["cpu"][2],
                               atol=ATOL, rtol=RTOL)
    for key, value in results["cpu"][3].items():
        torch.testing.assert_close(results["cuda"][3][key], value,
                                   atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# The deterministic segment sums (ops/scatter.segment_sum -> K4)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((3000, 64), torch.float32),
                                         ((3000, 16, 3), torch.float32),
                                         ((3000,), torch.float32),
                                         ((3000, 5), torch.float64),
                                         ((200_000, 160), torch.float32)])
def test_scatter_segment_sum_launches_k4(cuda_device, shape, dtype):
    """Any width, 1-3 dimensions, f32 or f64; the last case is one long
    segment per few rows (a pool of a box into 3 graphs: the block path)."""
    rng = np.random.default_rng(0)
    n = 3 if shape[0] > 100_000 else 700
    data = torch.from_numpy(rng.standard_normal(shape)).to(cuda_device, dtype)
    seg = torch.from_numpy(rng.integers(0, n, shape[0])).to(cuda_device)
    mask = torch.from_numpy(rng.random(shape[0]) > 0.1).to(cuda_device)
    before = sss.segment_sum.launches
    got = scatter.segment_sum(data, seg, n, mask)
    again = scatter.segment_sum(data, seg, n, mask)
    want = scatter.segment_sum_plain(data, seg, n, mask)
    assert sss.segment_sum.launches == before + 2
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    if shape[0] > 100_000:
        # 1e5-row f32 sums lie ~1e-2 from the exact one in any order: hold
        # both to a float64 sum
        exact = scatter.segment_sum_plain(data.double(), seg, n, mask)
        d_k = (got.double() - exact).abs().max().item()
        d_p = (want.double() - exact).abs().max().item()
        assert d_k <= 2 * d_p + tol * exact.abs().max().item()
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    mean = scatter.segment_mean(data, seg, n, mask)
    assert sss.segment_sum.launches == before + 4
    torch.testing.assert_close(
        mean.cpu(), scatter.segment_mean(data.cpu(), seg.cpu(), n, mask.cpu()),
        atol=tol, rtol=tol)


@pytest.mark.cuda
def test_plain_route_box_step_is_bitwise_repeatable(cuda_device):
    """Two runs of one plain-route egnn step (its message, position and
    pool sums and its embedding's gradient through K4) on the 10k-atom box
    give bitwise-equal gradients."""
    batch = bench_scale.box_batch(10_000, sort=False).to(cuda_device)
    grads = []
    before = sss.segment_sum.launches
    for _ in range(2):
        model = bench_scale.build("egnn", dict(num_layers=4, emb_dim=128),
                                  torch.Generator().manual_seed(0), cuda_device)
        bench_scale.make_step(model, batch)()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    # per step: 4 layers x (message sum + the position mean's two sums), the
    # pool and the embedding's gradient
    assert sss.segment_sum.launches - before == 2 * (4 * 3 + 2)
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


# ---------------------------------------------------------------------------
# The per-edge CG contraction (K7 forward and backward)
# ---------------------------------------------------------------------------

K7_SHAPES = [(70, 96, 16, 7, torch.float32), (64, 32, 8, 1, torch.float32),
             (33, 64, 16, 5, torch.bfloat16),
             (1400, 448, 64, 5, torch.float32),       # TFN hidden group
             (1400, 256, 192, 1, torch.float32),      # the gates
             (1400, 64, 192, 1, torch.bfloat16),      # layer 0's gates
             (20, 40, 300, 15, torch.float32)]        # w > 256, m = 15


@pytest.mark.cuda
@pytest.mark.parametrize("E,K,w,m,wdtype", K7_SHAPES)
def test_edge_contract_kernels_match_plain(cuda_device, E, K, w, m, wdtype):
    gen = torch.Generator(device=cuda_device).manual_seed(E + K)
    T = torch.randn((E, K, m), generator=gen, device=cuda_device)
    W = torch.randn((E, K, w), generator=gen, device=cuda_device).to(wdtype)
    dO = torch.randn((E, w, m), generator=gen, device=cuda_device)
    tol = 2e-5 if wdtype == torch.float32 else 3e-2
    before = (ec.edge_weighted_contract.launches,
              ec.edge_weighted_contract.bwd_launches)
    with torch.no_grad():
        got, again = (ec.edge_weighted_contract(T, W) for _ in range(2))
    (dT, dW), (dT2, dW2) = (ec.edge_weighted_contract_bwd(T, W, dO)
                            for _ in range(2))
    want = ec.edge_weighted_contract_plain(T, W)
    wdT, wdW = ec.edge_weighted_contract_bwd_plain(T, W, dO)
    assert (ec.edge_weighted_contract.launches,
            ec.edge_weighted_contract.bwd_launches) == (before[0] + 2,
                                                        before[1] + 2)
    assert torch.equal(got, again) and torch.equal(dT, dT2) and \
        torch.equal(dW, dW2)
    assert dW.dtype == wdtype and dT.dtype == torch.float32
    for g, r in ((got, want), (dT, wdT), (dW.float(), wdW.float())):
        scale = max(r.abs().max().item(), 1.0)
        torch.testing.assert_close(g, r, atol=tol * scale, rtol=0)


# one launch over groups (m, K, w) of every m up to 15, W in 16-byte
# vectors (4 f32 or 8 bf16 values per load); with ``odd_w`` one group's w is
# odd and every group takes the one-group kernel, one launch each
K7_GROUPS = [(1, 96, 64), (3, 40, 16), (5, 448, 64), (7, 384, 64),
             (9, 24, 32), (11, 8, 8), (13, 16, 192), (15, 33, 24)]


def _k7_groups(E, wdtype, device, seed, strided=False, odd_w=False):
    """Ts, Ws, dOs of ``K7_GROUPS`` at E edges; ``strided``: every W a
    slice of one wider tensor (the flat per-edge weights), read in place."""
    groups = [(m, k, w - (odd_w and i == 1)) for i, (m, k, w)
              in enumerate(K7_GROUPS)]
    gen = torch.Generator(device=device).manual_seed(seed)
    Ts = [torch.randn((E, k, m), generator=gen, device=device)
          for m, k, _ in groups]
    sizes = [k * w for _, k, w in groups]
    flat = torch.randn((E, sum(sizes) + 8), generator=gen,
                       device=device).to(wdtype)
    Ws, off = [], 0
    for (m, k, w), n in zip(groups, sizes):
        W = flat[:, off:off + n].reshape(E, k, w)
        Ws.append(W if strided else W.contiguous())
        off += n
    dOs = [torch.randn((E, w, m), generator=gen, device=device)
           for m, _, w in groups]
    return Ts, Ws, dOs


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 37, 1400])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided,odd_w", [(False, False), (True, False),
                                           (False, True)])
def test_grouped_contract_matches_plain(cuda_device, E, wdtype, strided,
                                        odd_w):
    """All groups in one launch each way (with ``odd_w`` one launch of the
    one-group kernel per group), within the JAX test's tolerances of the
    plain version group by group, dW in W's type, two runs bitwise equal."""
    Ts, Ws, dOs = _k7_groups(E, wdtype, cuda_device, E, strided, odd_w)
    tol = 2e-5 if wdtype == torch.float32 else 3e-2

    def count():
        return (ec.edge_weighted_contract_grouped.launches,
                ec.edge_weighted_contract_grouped.bwd_launches,
                ec.edge_weighted_contract.launches,
                ec.edge_weighted_contract.bwd_launches)

    before = count()
    with torch.no_grad():
        got, again = (ec.edge_weighted_contract_grouped(Ts, Ws)
                      for _ in range(2))
    grads, grads2 = (ec.edge_weighted_contract_grouped_bwd(Ts, Ws, dOs)
                     for _ in range(2))
    n = 2 * len(K7_GROUPS)
    want_counts = (0, 0, n, n) if odd_w else (2, 2, 0, 0)
    assert tuple(a - b for a, b in zip(count(), before)) == want_counts
    for g in range(len(K7_GROUPS)):
        want = ec.edge_weighted_contract_plain(Ts[g], Ws[g])
        wdT, wdW = ec.edge_weighted_contract_bwd_plain(Ts[g], Ws[g], dOs[g])
        dT, dW = grads[0][g], grads[1][g]
        assert torch.equal(got[g], again[g])
        assert torch.equal(dT, grads2[0][g]) and torch.equal(dW, grads2[1][g])
        assert dW.dtype == wdtype and dW.shape == Ws[g].shape
        for a, r in ((got[g], want), (dT, wdT), (dW.float(), wdW.float())):
            scale = max(r.abs().max().item(), 1.0)
            torch.testing.assert_close(a, r, atol=tol * scale, rtol=0)


@pytest.mark.cuda
def test_grouped_contract_autograd_reaches_strided_weights(cuda_device):
    """Through autograd with the weights as slices of one tensor: one launch
    each way, the flat tensor's and the Ts' gradients as on the CPU within
    the JAX test's 2e-5 of each one's largest entry (f32 sums in another
    order)."""
    Ts, _, _ = _k7_groups(29, torch.float32, cuda_device, 5)
    flat = torch.randn((29, sum(k * w for _, k, w in K7_GROUPS)),
                       device=cuda_device, requires_grad=True)
    Tl = [T.clone().requires_grad_(True) for T in Ts]

    def run(T_list, F):
        Ws, off = [], 0
        for (m, k, w) in K7_GROUPS:
            Ws.append(F[:, off:off + k * w].reshape(-1, k, w))
            off += k * w
        outs = ec.edge_weighted_contract_grouped(T_list, Ws)
        return sum((o * (i + 1)).square().sum() for i, o in enumerate(outs))

    before = (ec.edge_weighted_contract_grouped.launches,
              ec.edge_weighted_contract_grouped.bwd_launches)
    run(Tl, flat).backward()
    assert (ec.edge_weighted_contract_grouped.launches,
            ec.edge_weighted_contract_grouped.bwd_launches) == (
                before[0] + 1, before[1] + 1)
    Tc = [T.detach().cpu().requires_grad_(True) for T in Ts]
    Fc = flat.detach().cpu().requires_grad_(True)
    run(Tc, Fc).backward()
    for a, b in [(flat, Fc)] + list(zip(Tl, Tc)):
        scale = max(b.grad.abs().max().item(), 1.0)
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=2e-5 * scale,
                                   rtol=0)


@pytest.mark.cuda
def test_edge_contract_autograd_launches_bwd_kernel(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    T = torch.randn((50, 64, 3), generator=gen, device=cuda_device,
                    requires_grad=True)
    W = torch.randn((50, 64, 32), generator=gen, device=cuda_device,
                    requires_grad=True)
    before = (ec.edge_weighted_contract.launches,
              ec.edge_weighted_contract.bwd_launches)
    (ec.edge_weighted_contract(T, W) ** 2).sum().backward()
    assert (ec.edge_weighted_contract.launches,
            ec.edge_weighted_contract.bwd_launches) == (before[0] + 1,
                                                        before[1] + 1)
    Tc, Wc = (t.detach().cpu().requires_grad_(True) for t in (T, W))
    (ec.edge_weighted_contract(Tc, Wc) ** 2).sum().backward()
    torch.testing.assert_close(T.grad.cpu(), Tc.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(W.grad.cpu(), Wc.grad, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_edge_contract_kernel_raises_on_bad_input(cuda_device):
    T = torch.zeros((4, 6, 4), device=cuda_device)
    W = torch.zeros((4, 6, 3), device=cuda_device)
    with pytest.raises(ValueError, match="odd"):
        ec.edge_weighted_contract(T, W)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ec.edge_weighted_contract(T[..., :3], W.half())


@pytest.mark.cuda
def test_two_tfn_train_steps_on_card_match_cpu(cuda_device):
    """A narrow TFN (2 layers, emb_dim 8, max_ell 3, batch norm): the first
    step's gradients and two Adam steps' losses on the card (K7 both ways,
    K4) against the CPU's plain path.  Parameters after the two steps within
    2 lr: Adam's normalised step turns f32 rounding of a near-zero gradient
    into up to lr per step."""
    graphs = datasets.create_star_graphs(num=12, fold=(5, 6, 7), seed=0)
    host = graph.batch_graphs(graphs, *graph.pad_sizes(graphs, 12))
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        batch = host.to(dev)
        model = TFNModel(num_layers=2, emb_dim=8, max_ell=3, mlp_dim=32,
                         batch_norm=True, device=dev,
                         generator=torch.Generator().manual_seed(1))
        step = bench_throughput.make_step(model, batch)
        before = (ec.edge_weighted_contract_grouped.launches,
                  ec.edge_weighted_contract_grouped.bwd_launches,
                  sss.segment_sum.launches)
        losses = [step().item()]
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        losses.append(step().item())
        launched = (ec.edge_weighted_contract_grouped.launches - before[0],
                    ec.edge_weighted_contract_grouped.bwd_launches - before[1],
                    sss.segment_sum.launches - before[2])
        results[dev.type] = (losses, launched, grads, {
            k: v.cpu() for k, v in model.state_dict().items()})
    # K4: 2 message sums and the embedding's gradient per step
    assert results["cuda"][1] == (2 * 2, 2 * 2, 2 * 3)
    assert results["cpu"][1] == (0, 0, 0)
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-5)
    for name, ref in results["cpu"][2].items():
        torch.testing.assert_close(results["cuda"][2][name], ref, rtol=0,
                                   atol=1e-4 * max(ref.abs().max().item(), 1))
    for key, value in results["cpu"][3].items():
        torch.testing.assert_close(results["cuda"][3][key], value, rtol=1e-4,
                                   atol=2 * bench_throughput.LR)


@pytest.mark.cuda
def test_tfn_predictor_on_card_matches_cpu(cuda_device):
    graphs = datasets.create_star_graphs(num=30, fold=(5, 6, 7), seed=1)
    kw = dict(num_layers=2, emb_dim=16, max_ell=3,
              generator=torch.Generator().manual_seed(2))
    model = TFNModel(**kw, device=cuda_device)
    cpu = TFNModel(**kw, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    before = (ec.edge_weighted_contract_grouped.launches,
              ec.edge_weighted_contract_grouped.bwd_launches)
    y = Predictor(model, batch_size=10).predict(graphs)
    assert (ec.edge_weighted_contract_grouped.launches - before[0],
            ec.edge_weighted_contract_grouped.bwd_launches - before[1]) == (3 * 2, 0)
    np.testing.assert_allclose(
        y, Predictor(cpu, batch_size=10, device="cpu").predict(graphs),
        atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The triplet models: K3 over the ascending idx_ji, DimeNet++ steps
# ---------------------------------------------------------------------------


def _triplet_star_batch(num, device, quads=False):
    graphs = datasets.create_star_graphs(num=num, fold=(5, 6, 7), seed=0)
    loader = graph.GraphLoader(graphs, num, with_triplets=True,
                               with_quads=quads)
    return next(iter(loader)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 128])
def test_triplet_fold_identity_plan_matches_plain(cuda_device, d):
    """K3 over the identity plan of the ascending idx_ji (built on the
    card, masked rows zeroed in the data) against the plain sum, within
    1e-5, two runs bitwise equal, one launch each."""
    batch = _triplet_star_batch(100, cuda_device)
    tri = batch.triplets
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    y = torch.randn((tri.num_triplets, d), generator=gen, device=cuda_device)
    plan = sss.ascending_plan(tri.idx_ji, batch.num_edges)
    assert plan.rowptr.device == y.device and plan.identity_perm
    before = sss.sorted_segment_sum.launches
    got = sss.sorted_fold(y, tri.idx_ji, plan, tri.t_mask)
    again = sss.sorted_fold(y, tri.idx_ji, plan, tri.t_mask)
    assert sss.sorted_segment_sum.launches - before == 2
    want = sss.sorted_segment_sum_plain(y, tri.idx_ji, batch.num_edges,
                                        tri.t_mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again)


def _dimenet_step_grads(batch, device, dtype=torch.float32):
    model = bench_throughput.build("dimenet", torch.Generator().manual_seed(0),
                                   device).to(dtype)
    with torch.no_grad():
        for out in model.outputs:         # start away from the zero heads
            out.lin.weight.fill_(0.01)
    b = batch.to(device)
    b.pos, b.y = b.pos.to(dtype), b.y.to(dtype)
    train.l1_sum_loss(model(b), b).backward()
    return {n: p.grad.double().cpu() for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_dimenet_step_matches_cpu(cuda_device):
    """One DimeNet++ gradient at full width on 20 star graphs on the card
    (the fold on K3: 4 launches, one per block) against the CPU's plain
    float64 step: each gradient within 1e-3 of its largest entry."""
    batch = _triplet_star_batch(20, "cpu")
    before = sss.sorted_segment_sum.launches
    got = _dimenet_step_grads(batch, cuda_device)
    assert sss.sorted_segment_sum.launches - before == 4
    want = _dimenet_step_grads(batch, "cpu", torch.float64)
    for name, g in got.items():
        top = max(want[name].abs().max().item(), 1e-12)
        assert (g - want[name]).abs().max().item() <= 1e-3 * top, name


@pytest.mark.cuda
def test_dimenet_plain_route_step_is_bitwise_repeatable(cuda_device):
    """Two DimeNet++ steps on one star batch give bitwise-equal gradients:
    the fold is K3, the other sums K4, the gathers' backward sorted."""
    batch = _triplet_star_batch(100, cuda_device)
    first = _dimenet_step_grads(batch, cuda_device)
    second = _dimenet_step_grads(batch, cuda_device)
    for name, g in first.items():
        assert torch.equal(g, second[name]), name


# ---------------------------------------------------------------------------
# K4's scan route (no plan, no sort), long segments split inside a block,
# narrow rows, and the fold's mask and accumulator inside K3
# ---------------------------------------------------------------------------


def _k4_routes(data, seg, n, mask):
    """K4 twice on the scan route and once on the CSR route (a device sort,
    then the kernel), under no_grad."""
    saved = sss.SCAN_MAX_ROWS
    try:
        sss.SCAN_MAX_ROWS = 1 << 30
        with torch.no_grad():
            first = sss.segment_sum(data, seg, n, mask)
            second = sss.segment_sum(data, seg, n, mask)
        sss.SCAN_MAX_ROWS = -1
        with torch.no_grad():
            csr = sss.segment_sum(data, seg, n, mask)
    finally:
        sss.SCAN_MAX_ROWS = saved
    torch.cuda.synchronize()
    return first, second, csr


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,d,masked,all_in,dtype,index_dtype", [
    (800, 1, 128, 0.0, 0, torch.float32, torch.int32),     # embedding grad
    (808, 95, 128, 0.0, 0, torch.float32, torch.int32),    # DimeNet++'s
    (808, 101, 128, 0.01, None, torch.float32, torch.int64),  # star pool
    (1408, 808, 64, 0.15, None, torch.float32, torch.int32),  # message sums
    (1408, 808, 3, 0.15, None, torch.float32, torch.int64),   # positions
    (1408, 808, 1, 0.15, None, torch.float32, torch.int32),   # counts
    (1408, 808, 4, 0.15, None, torch.float32, torch.int32),
    (1408, 808, 8, 0.15, None, torch.float32, torch.int64),
    (1400, 300, 130, 0.1, None, torch.float32, torch.int32),  # scalar lanes
    (1400, 300, 256, 0.1, None, torch.float32, torch.int64),  # two passes
    (5000, 700, 16, 0.1, None, torch.float64, torch.int64),   # float64
    (24576, 6000, 128, 0.1, None, torch.float32, torch.int32),  # the limit
    (3000, 7, 32, 0.1, None, torch.float32, torch.int32),   # long, some masked
    (1500, 300, 32, 1.0, None, torch.float32, torch.int32),  # all masked
    (0, 20, 16, 0.0, None, torch.float32, torch.int64),      # no rows
])
def test_k4_scan_route_matches_plain(cuda_device, e, n, d, masked, all_in,
                                     dtype, index_dtype):
    """The scan route against the plain version at SEG_TOL, two runs
    bitwise equal; bitwise equal to the CSR route where no segment reaches
    LONG_SEG rows (both add a segment's rows in ascending order in one lane
    group), within SEG_TOL where one does (split across the block)."""
    data, seg, mask = _seg_case(e, n, d, 61, masked, False, cuda_device)
    if all_in is not None:
        seg = torch.full_like(seg, all_in)
    data, seg = data.to(dtype), seg.to(index_dtype)
    before = sss.segment_sum.launches
    first, second, csr = _k4_routes(data, seg, n, mask)
    assert sss.segment_sum.launches == before + 3
    want = sss.sorted_segment_sum_plain(data, seg, n, mask)
    tol = SEG_TOL if dtype == torch.float32 else 1e-12
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(first, want, atol=tol * scale, rtol=tol)
    assert torch.equal(first, second)
    longest = int(torch.bincount(seg[mask].long(), minlength=n).max()) if e else 0
    if longest < sss.LONG_SEG:
        assert torch.equal(first, csr)
    else:
        torch.testing.assert_close(first, csr, atol=tol * scale, rtol=tol)
    if masked == 1.0 or e == 0:
        assert torch.equal(first, torch.zeros_like(first))


@pytest.mark.cuda
def test_k4_scan_route_drops_ids_outside_the_segments(cuda_device):
    data, seg, mask = _seg_case(2000, 300, 64, 62, 0.1, False, cuda_device)
    seg[::7] = -3
    seg[::11] = 300 + 5
    first, second, csr = _k4_routes(data, seg, 300, mask)
    keep = mask & (seg >= 0) & (seg < 300)
    want = sss.sorted_segment_sum_plain(data, seg.clamp(0, 299), 300, keep)
    torch.testing.assert_close(first, want, atol=SEG_TOL, rtol=SEG_TOL)
    assert torch.equal(first, second) and torch.equal(first, csr)


@pytest.mark.cuda
def test_k4_scan_route_is_one_kernel_and_no_sort(cuda_device):
    """At the embedding gradient's shape the scan route is one device
    kernel a call and no sort."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    data, seg, _ = _seg_case(800, 1, 128, 63, 0.0, False, cuda_device)
    seg = torch.zeros_like(seg, dtype=torch.int32)
    with torch.no_grad():
        sss.segment_sum(data, seg, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sss.segment_sum(data, seg, 1)
            torch.cuda.synchronize()
    kernels = [ev.key for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "segsum" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("e,d,sort", [(3000, 64, True), (3000, 128, False),
                                      (3000, 3, False), (3000, 8, True),
                                      (40_000, 128, True), (40_000, 64, False)])
def test_k3_long_segments_split_inside_the_block(cuda_device, e, d, sort):
    """K3 over a plan with a segment of 900 rows among short ones (masked
    rows left out of the plan, and a plan without the mask, which the
    kernel reads), split across a cluster of blocks (E 3000) or one block
    (E 40k, above SCAN_MAX_ROWS): within SEG_TOL of the plain version,
    bitwise repeatable, one launch each."""
    n = e // 15
    data, seg, mask = _seg_case(e, n, d, 64, 0.1, sort, cuda_device)
    seg[:900] = 5
    if sort:
        seg = torch.sort(seg).values
    want = sss.sorted_segment_sum_plain(data, seg, n, mask)
    for plan in (sss.build_segment_plan(seg, n, mask=mask, device=cuda_device),
                 sss.build_segment_plan(seg, n, device=cuda_device)):
        assert bool(sss.long_segments(plan.rowptr)[5])
        before = sss.sorted_segment_sum.launches
        with torch.no_grad():
            first = sss.sorted_segment_sum(data, plan, seg, mask)
            second = sss.sorted_segment_sum(data, plan, seg, mask)
        torch.cuda.synchronize()
        assert sss.sorted_segment_sum.launches == before + 2
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(first, want, atol=SEG_TOL * scale,
                                   rtol=SEG_TOL)
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 128])
def test_fold_mask_and_accumulator_inside_k3(cuda_device, d):
    """The fold with its mask and an accumulator read by K3 is bitwise
    equal to the previous formula ``acc + sorted_fold`` (the kernel over
    masked-zeroed rows, then an add), and to the plain sum within 1e-5."""
    batch = _triplet_star_batch(100, cuda_device)
    tri = batch.triplets
    gen = torch.Generator(device=cuda_device).manual_seed(d + 1)
    y = torch.randn((tri.num_triplets, d), generator=gen, device=cuda_device)
    acc = torch.randn((batch.num_edges, d), generator=gen, device=cuda_device)
    plan = sss.ascending_plan(tri.idx_ji, batch.num_edges)
    before = sss.sorted_segment_sum.launches
    with torch.no_grad():
        got = sss.sorted_fold(y, tri.idx_ji, plan, tri.t_mask, acc=acc)
        again = sss.sorted_fold(y, tri.idx_ji, plan, tri.t_mask, acc=acc)
        alone = sss.sorted_fold(y, tri.idx_ji, plan, tri.t_mask)
        zeroed = torch.where(tri.t_mask[:, None], y, torch.zeros_like(y))
        fold = torch.empty_like(acc)
        sss.launch_csr_segsum(zeroed, None, plan.rowptr, fold)
    torch.cuda.synchronize()
    assert sss.sorted_segment_sum.launches - before == 3
    assert torch.equal(got, again)
    assert torch.equal(alone, fold)
    assert torch.equal(got, acc + fold)
    want = acc + sss.sorted_segment_sum_plain(y, tri.idx_ji, batch.num_edges,
                                              tri.t_mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_chunked_fold_accumulates_in_the_kernel(cuda_device):
    """TripletFold over 3 chunks: one K3 launch each, no other kernel but
    the rows' own, within 1e-5 of the plain sum; gradients as the plain
    version's."""
    from geometric_message_passing_tpu_torch.models.dimenet import TripletFold
    batch = _triplet_star_batch(100, cuda_device)
    tri = batch.triplets
    chunk = -(-tri.num_triplets // 3)
    fold = TripletFold(tri.idx_ji, tri.t_mask, batch.num_edges, chunk=chunk)
    gen = torch.Generator(device=cuda_device).manual_seed(71)
    y = torch.randn((tri.num_triplets, 64), generator=gen, device=cuda_device,
                    requires_grad=True)
    before = sss.sorted_segment_sum.launches
    got = fold.sum(lambda s: y[s])
    assert sss.sorted_segment_sum.launches - before == 3
    want = sss.sorted_segment_sum_plain(y.detach(), tri.idx_ji,
                                        batch.num_edges, tri.t_mask)
    torch.testing.assert_close(got.detach(), want, atol=1e-5, rtol=1e-5)
    (g,) = torch.autograd.grad(got.sum(), [y])
    assert torch.equal(g[:, 0], tri.t_mask.float())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["scan", "csr"])
@pytest.mark.parametrize("bad", ["short_ids", "short_mask", "ids_2d",
                                 "cpu_ids", "cpu_mask"])
def test_k4_rejects_ids_or_mask_that_do_not_fit_the_rows(cuda_device, route,
                                                        bad):
    """K4 raises, on either route, unless the ids and the mask have one
    entry a row on the data's device: the kernels read them by row."""
    data, seg, mask = _seg_case(1000, 50, 64, 65, 0.1, False, cuda_device)
    if bad == "short_ids":
        seg = seg[:-1]
    elif bad == "short_mask":
        mask = mask[:-1]
    elif bad == "ids_2d":
        seg = seg[:, None]
    elif bad == "cpu_ids":
        seg = seg.cpu()
    else:
        mask = mask.cpu()
    saved = sss.SCAN_MAX_ROWS
    sss.SCAN_MAX_ROWS = 1 << 30 if route == "scan" else -1
    try:
        with pytest.raises(ValueError), torch.no_grad():
            sss.segment_sum(data, seg, 50, mask)
    finally:
        sss.SCAN_MAX_ROWS = saved


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["short_mask", "long_mask", "cpu_mask"])
def test_k3_rejects_a_mask_that_does_not_fit_the_rows(cuda_device, bad):
    """K3 reads the mask of a plan built without it in the kernel: a mask
    of another length, or on the CPU, raises."""
    batch = _triplet_star_batch(100, cuda_device)
    tri = batch.triplets
    y = torch.randn((tri.num_triplets, 64), device=cuda_device)
    plan = sss.ascending_plan(tri.idx_ji, batch.num_edges)
    mask = {"short_mask": tri.t_mask[:-1],
            "long_mask": torch.cat([tri.t_mask, tri.t_mask[:1]]),
            "cpu_mask": tri.t_mask.cpu()}[bad]
    with pytest.raises(ValueError), torch.no_grad():
        sss.sorted_fold(y, tri.idx_ji, plan, mask)


# ---------------------------------------------------------------------------
# MACE: K7 at its group shapes, a train step on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_grouped_contract_at_mace_group_shapes_matches_plain(cuda_device):
    """MACE's ungated group sets at its star configuration (layer 0 and the
    hidden layer, E 1400, f32 W): one grouped launch each way, within the
    JAX test's 2e-5 of max(|ref|, 1) of the plain version group by group,
    two runs bitwise equal."""
    model = MACEModel(num_layers=2, max_ell=3, correlation=3, device="cpu")
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    for conv in model.convs:
        Ts, Ws, dOs = [], [], []
        for k, m, w in conv.tp.group_shapes:
            Ts.append(torch.randn((1400, k, m), generator=gen,
                                  device=cuda_device))
            Ws.append(torch.randn((1400, k, w), generator=gen,
                                  device=cuda_device))
            dOs.append(torch.randn((1400, w, m), generator=gen,
                                   device=cuda_device))
        before = (ec.edge_weighted_contract_grouped.launches,
                  ec.edge_weighted_contract_grouped.bwd_launches)
        with torch.no_grad():
            got, again = (ec.edge_weighted_contract_grouped(Ts, Ws)
                          for _ in range(2))
        grads, grads2 = (ec.edge_weighted_contract_grouped_bwd(Ts, Ws, dOs)
                         for _ in range(2))
        assert (ec.edge_weighted_contract_grouped.launches - before[0],
                ec.edge_weighted_contract_grouped.bwd_launches
                - before[1]) == (2, 2)
        for g, (T, W, dO) in enumerate(zip(Ts, Ws, dOs)):
            wdT, wdW = ec.edge_weighted_contract_bwd_plain(T, W, dO)
            for a, b, r in ((got[g], again[g],
                             ec.edge_weighted_contract_plain(T, W)),
                            (grads[0][g], grads2[0][g], wdT),
                            (grads[1][g], grads2[1][g], wdW)):
                assert torch.equal(a, b)
                scale = max(r.abs().max().item(), 1.0)
                torch.testing.assert_close(a, r, atol=2e-5 * scale, rtol=0)


@pytest.mark.cuda
def test_mace_train_step_on_card_matches_cpu(cuda_device):
    """A narrow MACE (2 layers, emb_dim 8, max_ell 3, correlation 3, batch
    norm, sum pool): the first step's loss and gradients on the card (K7
    both ways once a layer, K4 for the two message sums, the pool and the
    embedding's gradient) against the CPU's
    plain path, gradients within 1e-4 of each parameter's max(|ref|, 1), and
    the batch-norm statistics after it within 1e-5."""
    graphs = datasets.create_star_graphs(num=12, fold=(5, 6, 7), seed=3)
    host = graph.batch_graphs(graphs, *graph.pad_sizes(graphs, 12))
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        batch = host.to(dev)
        model = MACEModel(num_layers=2, emb_dim=8, max_ell=3, correlation=3,
                          mlp_dim=32, device=dev,
                          generator=torch.Generator().manual_seed(4))
        step = bench_throughput.make_step(model, batch)
        before = (ec.edge_weighted_contract_grouped.launches,
                  ec.edge_weighted_contract_grouped.bwd_launches,
                  sss.segment_sum.launches)
        loss = step().item()
        launched = (ec.edge_weighted_contract_grouped.launches - before[0],
                    ec.edge_weighted_contract_grouped.bwd_launches - before[1],
                    sss.segment_sum.launches - before[2])
        results[dev.type] = (loss, launched, {
            n: p.grad.cpu() for n, p in model.named_parameters()}, {
            n: b.cpu() for n, b in model.named_buffers()})
    assert results["cuda"][1] == (2, 2, 4)
    assert results["cpu"][1] == (0, 0, 0)
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0],
                               rtol=1e-5)
    for name, ref in results["cpu"][2].items():
        torch.testing.assert_close(results["cuda"][2][name], ref, rtol=0,
                                   atol=1e-4 * max(ref.abs().max().item(), 1))
    for name, ref in results["cpu"][3].items():
        torch.testing.assert_close(results["cuda"][3][name], ref, rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# MACE's force fields: K4 at the convolutions' chunk widths, a box step
# ---------------------------------------------------------------------------

# the 10k box's chunk sums: 16384 rows into 10k nodes, D tp.irreps_out.dim
# of MACE-FF's layers 0 / 1 (1024, 6336) and TFN-FF's (576, 2240); the
# padded tail chunk keeps 14536 live rows
FF_K4_CASES = [(16384, 10_000, d, live) for d in (1024, 6336, 576, 2240)
               for live in (16384, 14536)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,n,d,live", FF_K4_CASES)
def test_segment_sum_at_force_field_widths(cuda_device, e, n, d, live):
    """K4 (the scan route, one launch) at the chunk sums' shapes: within
    SEG_TOL of the plain version, bitwise equal twice."""
    assert sss.segsum_route(e, n)[0] == "scan"
    rng = np.random.default_rng(d + live)
    seg = torch.from_numpy(rng.integers(0, n, e)).to(cuda_device)
    mask = torch.from_numpy(np.arange(e) < live).to(cuda_device)
    data = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32)).to(
        cuda_device)
    before = sss.segment_sum.launches
    with torch.no_grad():
        first = sss.segment_sum(data, seg, n, mask)
        second = sss.segment_sum(data, seg, n, mask)
        want = sss.sorted_segment_sum_plain(data, seg, n, mask)
    torch.cuda.synchronize()
    assert sss.segment_sum.launches == before + 2
    assert torch.equal(first, second)
    torch.testing.assert_close(first, want, atol=SEG_TOL, rtol=SEG_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mace_ff", "tfn_ff"])
def test_force_field_box_step_on_card_matches_cpu(cuda_device, name):
    """A narrow force field (emb 8; edge chunks of 4100 over the 8064 edges
    of a 700-atom box: the bcast form and a padded tail; MACE-FF in node
    blocks of 300) one bench_scale step: K4 exactly
    ``ff_k4_launches_per_step`` times, gradients within 1e-4 of each
    parameter's max(|ref|, 1) of the CPU's plain step, and twice on the
    card bitwise equal."""
    box = bench_scale.box_batch(700, sort=False)
    cfg = dict(bench_scale.config(name, 700), emb_dim=8, edge_chunk=4100)
    if name == "mace_ff":
        cfg["node_chunk"] = 300
    deg = bench_scale.mean_degree(box)
    grads = {}
    for run, dev in (("cuda", cuda_device), ("cuda again", cuda_device),
                     ("cpu", torch.device("cpu"))):
        model = bench_scale.build(name, cfg, torch.Generator().manual_seed(0),
                                  dev, avg_deg=deg)
        before = sss.segment_sum.launches
        bench_scale.make_step(model, box.to(dev))()
        launched = sss.segment_sum.launches - before
        if dev.type == "cuda":
            assert launched == bench_scale.ff_k4_launches_per_step(
                name, cfg["num_layers"], bench_scale.edge_chunks(cfg, box))
        grads[run] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    for n, ref in grads["cpu"].items():
        assert torch.equal(grads["cuda"][n], grads["cuda again"][n]), n
        torch.testing.assert_close(grads["cuda"][n], ref, rtol=0,
                                   atol=1e-4 * max(ref.abs().max().item(), 1))


def _dp_card_rank() -> dict:
    """Two dp steps of a narrow EGNNFusedModel on this rank's half of 16
    star graphs (K1/K2 on every rank), counters read per rank."""
    from geometric_message_passing_tpu_torch.parallel import (
        dp_train_step, make_mesh, shard_batches)

    mesh = make_mesh()
    graphs = datasets.create_star_graphs(num=16, fold=[4, 5], dim=3, seed=0)
    pads = graph.pad_sizes(graphs, 8)
    model = EGNNFusedModel(2, 32, 1, 1, pool="first", device=mesh.device,
                           generator=torch.Generator().manual_seed(0))
    step = dp_train_step(model, train.make_tx(model.parameters(), 1e-3), mesh,
                         train.l1_sum_loss)
    shard = shard_batches(graphs, 2, *pads)[mesh.coords["dp"]].to(mesh.device)
    before = (edge.egnn_message.launches, edge.egnn_message.bwd_launches)
    losses = [float(step(shard)) for _ in range(2)]
    launched = (edge.egnn_message.launches - before[0],
                edge.egnn_message.bwd_launches - before[1])
    return {"device": str(mesh.device), "launched": launched,
            "losses": losses,
            "state": {k: v.cpu().numpy() for k, v in model.state_dict().items()}}


@pytest.mark.cuda
def test_dp_two_gloo_ranks_share_the_card(cuda_device):
    """Two gloo ranks on one card (NCCL refuses that: it raises before any
    process starts) equal two plain steps on the concatenated batch here:
    weights within 1e-5, K1 and K2 twice per layer on each rank."""
    from geometric_message_passing_tpu_torch.parallel import launch

    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="one GPU per rank"):
            launch.spawn(_dp_card_rank, 2, backend="nccl")
    ranks = launch.spawn(_dp_card_rank, 2, backend="gloo", timeout_s=300)
    graphs = datasets.create_star_graphs(num=16, fold=[4, 5], dim=3, seed=0)
    pads = graph.pad_sizes(graphs, 8)
    big = graph.batch_graphs(graphs, *(2 * p for p in pads)).to(cuda_device)
    model = EGNNFusedModel(2, 32, 1, 1, pool="first", device=cuda_device,
                           generator=torch.Generator().manual_seed(0))
    opt = train.make_tx(model.parameters(), 1e-3)
    for _ in range(2):
        loss = train.l1_sum_loss(model(big), big)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    for r in ranks:
        assert r["device"] == "cuda:0" and r["launched"] == (4, 4)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(r["state"][k], v.cpu().numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)


def _tp_card_model(device):
    # no batch norm: its backward amplifies f32 rounding (PERF.md)
    return MACEModel(num_layers=2, emb_dim=16, max_ell=2, correlation=2,
                     pool="first", batch_norm=False, in_dim=1, out_dim=1,
                     device=device, generator=torch.Generator().manual_seed(0))


def _tp_card_batch(device):
    graphs = datasets.create_star_graphs(num=8, fold=[4, 5], dim=3, seed=0)
    return graph.batch_graphs(graphs, *graph.pad_sizes(graphs, 8)).to(device)


def _tp_card_rank() -> dict:
    """A narrow MACE sharded on its channels over two ranks: the forward
    and one SGD step's gradients, K7 / K4 counted per rank."""
    from geometric_message_passing_tpu_torch.parallel import (
        make_mesh, shard_model_variables, tp_apply, tp_local_model,
        tp_train_step)

    mesh = make_mesh((2,), ("tp",))
    full = _tp_card_model(mesh.device)
    batch = _tp_card_batch(mesh.device)
    shard = shard_model_variables(full.state_dict(), full, 2)[
        mesh.coords["tp"]]
    before = (ec.edge_weighted_contract_grouped.launches,
              sss.segment_sum.launches)
    y = tp_apply(full, shard, mesh)(batch)
    launched = (ec.edge_weighted_contract_grouped.launches - before[0],
                sss.segment_sum.launches - before[1])
    local = tp_local_model(full, 2, mesh)
    local.load_state_dict(shard)
    tp_train_step(local, torch.optim.SGD(local.parameters(), lr=1.0), mesh,
                  train.l1_sum_loss)(batch)
    return {"device": str(mesh.device), "launched": launched,
            "y": y.cpu().numpy(),
            "grads": {n: p.grad.cpu().numpy()
                      for n, p in local.named_parameters()}}


@pytest.mark.cuda
def test_tp_two_gloo_ranks_share_the_card(cuda_device):
    """MACE at tp 2 on two gloo ranks sharing the card: the forward within
    1e-5 of one process's, each rank's gradients the sharded single-rank
    gradients (1e-4 of each tensor's largest entry), K7 and K4 once per
    layer on each rank's forward."""
    from geometric_message_passing_tpu_torch.parallel import (
        launch, shard_model_variables)

    ranks = launch.spawn(_tp_card_rank, 2, backend="gloo", timeout_s=300)
    model = _tp_card_model(cuda_device)
    batch = _tp_card_batch(cuda_device)
    with torch.no_grad():
        want = model(batch).cpu().numpy()
    loss = train.l1_sum_loss(model(batch), batch)
    loss.backward()
    grads = shard_model_variables(
        {n: p.grad.cpu() for n, p in model.named_parameters()}, model, 2)
    for p, r in enumerate(ranks):
        assert r["device"] == "cuda:0" and r["launched"] == (2, 2)
        np.testing.assert_allclose(r["y"], want, atol=1e-5, rtol=0)
        for n, g in grads[p].items():
            scale = max(max(s[n].abs().max().item() for s in grads), 1e-30)
            err = np.abs(r["grads"][n] - g.numpy()).max()
            assert err <= 1e-4 * scale, n


def _gp_card_rank() -> dict:
    """A narrow MACE-FF edge-partitioned over four ranks on a 600-atom
    Morton box: the energies and the gradients of sum(E^2) summed over the
    axis, K4 counted per rank."""
    from geometric_message_passing_tpu_torch.parallel import (
        build_halo_plan, gp_rank_batch, make_mesh)
    from geometric_message_passing_tpu_torch.parallel.data import (
        all_reduce_grads)

    mesh = make_mesh((4,), ("gp",))
    box = _gp_card_box()
    plan = build_halo_plan(box.senders.numpy(), box.receivers.numpy(),
                           box.num_nodes, 4, edge_mask=box.edge_mask.numpy()
                           ).to(mesh.device)
    model = _gp_card_model(mesh.device, gp_axis="gp", mesh=mesh)
    me = mesh.coords["gp"]
    before = sss.segment_sum.launches
    energy = model(gp_rank_batch(box.to(mesh.device), plan, me),
                   halo_plan=plan.local(me))
    launched = sss.segment_sum.launches - before
    (energy ** 2).sum().backward()
    all_reduce_grads(mesh, list(model.parameters()), "gp")
    return {"device": str(mesh.device), "launched": launched,
            "e_loc": int(plan.edge_src_cat.shape[1]),
            "energy": energy.detach().cpu().numpy(),
            "grads": {n: p.grad.cpu().numpy()
                      for n, p in model.named_parameters()}}


def _gp_card_box():
    from geometric_message_passing_tpu_torch.parallel import (
        morton_partition_graph)

    g = datasets.create_molecular_boxes(num=1, n_nodes=600, cutoff=3.0,
                                        avg_degree=14.0, n_species=8,
                                        seed=0)[0]
    g = morton_partition_graph(g)
    n_pad, e_pad, g_pad = graph.pad_sizes([g], 1)
    return graph.batch_graphs([g], -(-n_pad // 4) * 4, e_pad, g_pad)


def _gp_card_model(device, **kw):
    from geometric_message_passing_tpu_torch.models import MACEForceField

    return MACEForceField(num_layers=2, emb_dim=8, max_ell=2, correlation=2,
                          in_dim=8, node_chunk=None, edge_chunk=1024,
                          generator=torch.Generator().manual_seed(0),
                          device=device, **kw)


@pytest.mark.cuda
def test_gp_four_gloo_ranks_share_the_card(cuda_device):
    """MACE-FF edge-partitioned over four gloo ranks sharing the card: the
    energies within 5e-4 + 1e-4 |ref| of one process's and the summed
    gradients within 2e-3 of each tensor's largest entry (the JAX gp
    tests' tolerances); K4 on every rank's sums (2 layers x (local chunks
    + the pool))."""
    from geometric_message_passing_tpu_torch.parallel import launch

    ranks = launch.spawn(_gp_card_rank, 4, backend="gloo", timeout_s=300)
    model = _gp_card_model(cuda_device)
    box = _gp_card_box().to(cuda_device)
    energy = model(box)
    (energy ** 2).sum().backward()
    want = energy.detach().cpu().numpy()
    for r in ranks:
        assert r["device"] == "cuda:0"
        assert r["launched"] == 2 * (-(-r["e_loc"] // 1024) + 1)
        np.testing.assert_allclose(r["energy"], want, atol=5e-4, rtol=1e-4)
        for n, p in model.named_parameters():
            g = p.grad.cpu().numpy()
            scale = max(np.abs(g).max(), 1.0)
            assert np.abs(r["grads"][n] - g).max() <= 2e-3 * scale, n
