"""The port's sorted segment sum (K3), sorted gather and segment sum over
unsorted ids (K4) against the JAX package's: forward and gradient at the
cases of ``tests/test_pallas.py``'s ``TestSortedSegmentSum``.  JAX runs its
Pallas kernels in interpret mode; the port on the CPU runs the kernels'
plain version.  The plan the card's kernel reads is checked against the JAX
plan and by summing through it here in numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.ops import pallas_sorted_segsum as jss
from geometric_message_passing_tpu.ops.pallas_edge import segment_sum_pallas
from geometric_message_passing_tpu.ops.scatter import segment_sum as jax_segment_sum
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

TOL = 1e-5      # the JAX test's own (test_pallas.py:481)
CASES = [(3000, 700), (5000, 128), (2000, 50)]


def _case(e, n, seed=0, sort_input=False, d=64, masked=0.1):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n, e).astype(np.int32)
    if sort_input:
        seg = np.sort(seg)
    data = rng.standard_normal((e, d)).astype(np.float32)
    mask = rng.random(e) >= masked
    return data, seg, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _through_plan(data, plan):
    """What the card's kernel computes from the plan, in numpy."""
    perm, rowptr = plan.perm.numpy(), plan.rowptr.numpy()
    out = np.zeros((plan.num_segments, data.shape[1]), np.float64)
    for s in range(plan.num_segments):
        rows = perm[rowptr[s]:rowptr[s + 1]]
        out[s] = data[rows].astype(np.float64).sum(axis=0)
    return out


@pytest.mark.parametrize("sort_input", [False, True])
@pytest.mark.parametrize("e,n", CASES)
def test_sorted_segment_sum_matches_jax(e, n, sort_input):
    data, seg, mask = _case(e, n, sort_input=sort_input)
    jplan = jss.build_segment_tile_plan(seg, n, mask=mask, interpret=True)
    perm, starts, local = jss.plan_args(jplan)
    seg_j, mask_j = jnp.asarray(seg), jnp.asarray(mask)

    def f(x):
        return jss.sorted_segment_sum(x, perm, starts, local, seg_j, mask_j,
                                      jplan.cfg)

    want = np.asarray(f(jnp.asarray(data)))
    g_want = np.asarray(jax.grad(lambda x: jnp.sum(f(x) ** 2))(
        jnp.asarray(data)))

    plan = sss.build_segment_plan(seg, n, mask=mask)
    np.testing.assert_array_equal(plan.perm.numpy(), jplan.perm)
    assert plan.identity_perm == jplan.cfg.identity_perm
    x, seg_t, mask_t = _t(data, seg, mask)
    x.requires_grad_()
    out = sss.sorted_segment_sum(x, plan, seg_t, mask_t)
    (g,) = torch.autograd.grad((out ** 2).sum(), [x])
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_through_plan(data, plan), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sort_input", [False, True])
@pytest.mark.parametrize("e,n", CASES)
def test_sorted_gather_matches_jax(e, n, sort_input):
    data, seg, mask = _case(e, n, seed=1, sort_input=sort_input)
    h = np.random.default_rng(2).standard_normal((n, 64)).astype(np.float32)
    jplan = jss.build_segment_tile_plan(seg, n, mask=mask, interpret=True)
    perm, starts, local = jss.plan_args(jplan)

    def f(h_):
        return jss.sorted_gather(h_, jnp.asarray(seg), perm, starts, local,
                                 jnp.asarray(mask), jplan.cfg)

    want = np.asarray(f(jnp.asarray(h)))
    g_want = np.asarray(jax.grad(lambda h_: jnp.sum(f(h_) * data))(
        jnp.asarray(h)))

    plan = sss.build_segment_plan(seg, n, mask=mask)
    h_t, seg_t, mask_t, data_t = _t(h, seg, mask, data)
    h_t.requires_grad_()
    out = sss.sorted_gather(h_t, seg_t, plan, mask_t)
    (g,) = torch.autograd.grad((out * data_t).sum(), [h_t])
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=TOL, atol=TOL)
    # the card's backward sums the cotangent through the plan
    np.testing.assert_allclose(_through_plan(data, plan), g_want,
                               rtol=TOL, atol=TOL)


def test_all_masked_and_empty_segments():
    e, n = 1500, 300
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 40, e).astype(np.int32)        # segments 40+ empty
    data = rng.standard_normal((e, 32)).astype(np.float32)
    mask = np.zeros(e, bool)
    jplan = jss.build_segment_tile_plan(seg, n, mask=mask, interpret=True)
    want = np.asarray(jss.sorted_segment_sum(
        jnp.asarray(data), *jss.plan_args(jplan), jnp.asarray(seg),
        jnp.asarray(mask), jplan.cfg))
    plan = sss.build_segment_plan(seg, n, mask=mask)
    assert plan.rowptr.tolist() == [0] * (n + 1)     # no row holds an edge
    out = sss.sorted_segment_sum(*_t(data), plan, *_t(seg, mask))
    assert out.shape == (n, 32) == want.shape
    assert torch.equal(out, torch.zeros_like(out))
    # empty segments, some edges live
    mask = rng.random(e) > 0.5
    plan = sss.build_segment_plan(seg, n, mask=mask)
    out = sss.sorted_segment_sum(*_t(data), plan, *_t(seg, mask)).numpy()
    assert np.all(out[40:] == 0)
    np.testing.assert_allclose(out, _through_plan(data, plan), rtol=TOL,
                               atol=TOL)


def test_plan_rows_and_identity():
    seg = np.array([0, 0, 2, 2, 2, 4], np.int64)
    plan = sss.build_segment_plan(seg, 6)
    assert plan.identity_perm and not plan.masked
    assert plan.rowptr.tolist() == [0, 2, 2, 5, 5, 6, 6]
    mask = np.array([1, 1, 1, 0, 1, 1], bool)      # a masked edge mid-list
    plan = sss.build_segment_plan(seg, 6, mask=mask)
    assert not plan.identity_perm and plan.masked
    assert plan.perm.tolist() == [0, 1, 2, 4, 5, 3]
    assert plan.rowptr.tolist() == [0, 2, 2, 4, 4, 5, 5]
    with pytest.raises(ValueError):
        sss.build_segment_plan(seg, 4)             # id 4 outside [0, 4)
    sss.build_segment_plan(seg, 4, mask=seg < 4)   # masked off: allowed


def test_segment_sum_matches_pallas():
    rng = np.random.default_rng(0)
    e, d, n = 700, 64, 100
    data = rng.normal(size=(e, d)).astype(np.float32)
    seg = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.2
    want = np.asarray(segment_sum_pallas(
        jnp.asarray(data), jnp.asarray(seg), n, mask=jnp.asarray(mask),
        block_edges=256, interpret=True))
    g_want = np.asarray(jax.grad(lambda x: jnp.sum(jax_segment_sum(
        x, jnp.asarray(seg), n, mask=jnp.asarray(mask)) ** 2))(
            jnp.asarray(data)))
    x, seg_t, mask_t = _t(data, seg, mask)
    x.requires_grad_()
    before = sss.segment_sum.launches
    out = sss.segment_sum(x, seg_t, n, mask_t)
    (g,) = torch.autograd.grad((out ** 2).sum(), [x])
    assert sss.segment_sum.launches == before      # the CPU runs no kernel
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), g_want, rtol=TOL, atol=1e-4)
    out_nomask = sss.segment_sum(torch.from_numpy(data), seg_t, n)
    np.testing.assert_allclose(out_nomask.numpy(), np.asarray(jax_segment_sum(
        jnp.asarray(data), jnp.asarray(seg), n)), rtol=TOL, atol=1e-4)


def test_cpu_launches_no_kernel():
    data, seg, mask = _case(300, 50, d=8)
    plan = sss.build_segment_plan(seg, 50, mask=mask)
    before = sss.sorted_segment_sum.launches
    h = torch.zeros((50, 8), requires_grad=True)
    sss.sorted_gather(h, torch.from_numpy(seg), plan,
                      torch.from_numpy(mask)).sum().backward()
    sss.sorted_segment_sum(*_t(data), plan, *_t(seg, mask))
    assert sss.sorted_segment_sum.launches == before


def test_long_segments_take_the_chunked_path():
    """The kernel's chunked path (few, long segments: a pool of a box) is
    chosen from the row and segment counts alone, with enough chunks to
    fill the card and at most MAX_CHUNKS."""
    assert sss.segment_chunks(1_350_912, 100_008) == 0      # the box's edges
    assert sss.segment_chunks(800, 100) == 0                # a star pool
    assert sss.segment_chunks(100_008, 2) == sss.MAX_CHUNKS  # a box pool
    assert sss.segment_chunks(200_000, 100) == 3
    assert sss.segment_chunks(5, 0) == 0
