"""K4's routes and the fold's accumulator form on the CPU.

* ``sorted_segsum.segsum_route`` is a pure function of the row and segment
  counts: every star shape the models launch (message sums, pools, the
  embeddings' gradients) takes the scan route (one launch, no sort); the
  10k and 100k boxes take the CSR route, chunked for a box pool.
* K4's CPU path (the kernel's plain version) against the JAX package's
  ``segment_sum_pallas`` in interpret mode, forward, and its gradient
  against ``jax.grad`` of the JAX ``segment_sum``, at the embedding
  gradient's shapes (all rows in one segment, alone or among 95) and the
  star pool's (8 rows a graph).
* The triplet fold over several chunks, each chunk's sum added to the
  accumulator (``sorted_fold(..., acc=)`` and ``segment_sum_into``), against
  the JAX ``segment_sum`` of all rows, forward and gradients.

Tolerance 1e-5 (the JAX test's own, ``tests/test_pallas.py:481``): f32 sums
in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.ops.pallas_edge import segment_sum_pallas
from geometric_message_passing_tpu.ops.scatter import segment_sum as jax_segment_sum
from geometric_message_passing_tpu_torch.models.dimenet import TripletFold
from geometric_message_passing_tpu_torch.ops import scatter
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

TOL = 1e-5


@pytest.mark.parametrize("rows,n,route", [
    (800, 1, "scan"),            # EGNN / GVP / TFN / SphereNet embedding grad
    (808, 95, "scan"),           # DimeNet++'s Embedding(95) gradient
    (800, 100, "scan"),          # SchNet's Embedding(100) gradient
    (808, 101, "scan"),          # a star sum pool: 8 rows a graph
    (1408, 808, "scan"),         # TFN / DimeNet++ message sums
    (4224, 1408, "scan"),        # the fold's ids at the DimeNet++ bucket
    (129_280, 10_000, "csr"),    # the 10k box's edges
    (1_350_912, 100_008, "csr"),  # the 100k box's edges
    (100_008, 2, "csr"),         # the 100k box's sum pool: chunked
])
def test_route_is_chosen_from_the_counts(rows, n, route):
    assert sss.segsum_route(rows, n)[0] == route
    chunks = sss.segsum_route(rows, n)[1]
    assert chunks == (sss.segment_chunks(rows, n) if route == "csr" else 0)


def test_route_limits():
    limit = sss.SCAN_MAX_ROWS
    assert sss.segsum_route(limit, limit // 2) == ("scan", 0)
    assert sss.segsum_route(limit + 1, limit // 2) == ("csr", 0)
    # few long segments take the chunked CSR route even below the limit
    assert sss.segsum_route(8192, 2) == ("csr", sss.segment_chunks(8192, 2))
    assert sss.segsum_route(0, 5) == ("scan", 0)
    rowptr = torch.tensor([0, 3, 3 + sss.LONG_SEG, 3 + 2 * sss.LONG_SEG - 1])
    assert sss.long_segments(rowptr).tolist() == [False, True, False]
    # the star buckets run in clusters, the boxes one block a segment range
    assert sss.cluster_size(4224) == sss.CLUSTER > 1
    assert sss.cluster_size(sss.CLUSTER_MAX_ROWS + 1) == 1
    assert sss.cluster_size(1_350_912) == 1


def _pallas_case(e, n, d, seed, all_in=None, masked=0.0):
    rng = np.random.default_rng(seed)
    seg = (np.full(e, all_in, np.int32) if all_in is not None
           else np.repeat(np.arange(n, dtype=np.int32), -(-e // n))[:e])
    data = rng.standard_normal((e, d)).astype(np.float32)
    mask = rng.random(e) >= masked
    return data, seg, mask


@pytest.mark.parametrize("e,n,all_in,masked", [
    (800, 1, 0, 0.0),        # every row into the one segment
    (808, 95, 0, 0.0),       # 95 segments, every row in segment 0
    (808, 101, None, 0.01),  # the star pool: 8 rows a graph, pads masked
])
def test_k4_cpu_matches_pallas_at_star_shapes(e, n, all_in, masked):
    data, seg, mask = _pallas_case(e, n, 128, seed=e + n, all_in=all_in,
                                   masked=masked)
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(data), jnp.asarray(seg), n, mask=jnp.asarray(mask),
        block_edges=256, interpret=True))
    g_want = np.asarray(jax.grad(lambda x: jnp.sum(jax_segment_sum(
        x, jnp.asarray(seg), n, mask=jnp.asarray(mask)) ** 2))(
            jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_()
    before = sss.segment_sum.launches
    out = scatter.segment_sum(x, torch.from_numpy(seg), n,
                              torch.from_numpy(mask))
    (g,) = torch.autograd.grad((out ** 2).sum(), [x])
    assert sss.segment_sum.launches == before     # the CPU runs no kernel
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL,
                               atol=TOL * scale)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("chunk", [None, 40, 97])
def test_chunked_fold_with_accumulator_matches_jax(chunk):
    rng = np.random.default_rng(5)
    n, t, d = 60, 300, 16
    ids = np.sort(rng.integers(0, n - 5, t)).astype(np.int32)
    ids[-25:] = n - 1                     # a slot's pad rows on its last edge
    mask = rng.random(t) > 0.1
    mask[-25:] = False
    rows = rng.standard_normal((t, d)).astype(np.float32)
    want = np.asarray(jax_segment_sum(jnp.asarray(rows), jnp.asarray(ids), n,
                                      mask=jnp.asarray(mask)))
    x = torch.from_numpy(rows).requires_grad_()
    fold = TripletFold(torch.from_numpy(ids), torch.from_numpy(mask), n,
                       chunk=chunk)
    assert len(fold.slices) == (1 if chunk is None else -(-t // chunk))
    got = fold.sum(lambda s: x[s])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL)
    assert not got[n - 5:n - 1].any()     # edges without triplets give 0
    (g,) = torch.autograd.grad(got.sum(), [x])
    np.testing.assert_array_equal(g.numpy()[:, 0], mask.astype(np.float32))
    # segment_sum_into over the same chunks: the same sums, and the
    # accumulator's gradient is the cotangent
    acc0 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    acc = acc0.clone().requires_grad_()
    total = acc
    for s, plan in zip(fold.slices, fold.plans):
        total = scatter.segment_sum_into(total, x[s], fold.idx_ji[s],
                                         fold.t_mask[s], plan=plan)
    np.testing.assert_allclose(total.detach().numpy(),
                               acc0.numpy() + want, rtol=TOL, atol=TOL)
    g_acc, g_x = torch.autograd.grad((total * 2).sum(), [acc, x])
    assert torch.equal(g_acc, torch.full_like(g_acc, 2.0))
    np.testing.assert_array_equal(g_x.numpy()[:, 0], 2 * mask.astype(np.float32))
