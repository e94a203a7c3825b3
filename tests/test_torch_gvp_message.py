"""The port's GVP message pass (``ops/gvp_message.py``) against the JAX
package's: the plain forward and the ``GVPMessage`` autograd function on the
CPU against ``gvp_message_xla`` and the Pallas kernel in interpret mode, the
hand-written backward against ``jax.vjp`` of the twin and the interpret-mode
Pallas backward, at the JAX tests' shapes (``tests/test_pallas.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu.ops.pallas_gvp import (
    gvp_message_xla, make_gvp_message_fused)
from geometric_message_passing_tpu_torch.experiments import bench_scale
from geometric_message_passing_tpu_torch.ops import gvp_message as gm
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss

FWD_ATOL = 2e-5   # the JAX test's, f32 sums in another order
GRAD_REL = 2e-4   # the JAX test's: 2e-4 x max(|ref|, 1)


def _inputs(n, e, node_dims, edge_dims, n_layers, seed, masked=0.15):
    """numpy inputs as the JAX test draws them: node and edge features,
    indices, mask and chain weights in the flat order (``bs`` [1, so])."""
    rng = np.random.default_rng(seed)
    (si, vi), (se, ve) = node_dims, edge_dims
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    s, v, es, ev = f(n, si), f(n, vi, 3), f(e, se), f(e, ve, 3)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    emask = rng.random(e) > masked
    dims = [(2 * si + se, 2 * vi + ve)] + [tuple(node_dims)] * n_layers
    ws = []
    for k in range(n_layers):
        (sik, vik), (sok, vok) = dims[k], dims[k + 1]
        hk = max(vik, vok)
        ws += [f(vik, hk) * 0.2, f(hk, vok) * 0.2, f(sik + hk, sok) * 0.1,
               f(1, sok) * 0.1, f(sok, vok) * 0.1, f(1, vok) * 0.1]
    planes = [np.ascontiguousarray(v[..., c]) for c in range(3)]
    eplanes = [np.ascontiguousarray(ev[..., c]) for c in range(3)]
    return (send, recv, emask), [s, *planes], [es, *eplanes], ws


def _torch(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


SHAPES = [
    (40, 150, (16, 4), (8, 1), 3, 5),
    (20, 70, (12, 4), (6, 1), 3, 6),
    (20, 70, (12, 4), (6, 1), 1, 7),
]


@pytest.mark.parametrize("n,e,node,edge,layers,seed", SHAPES)
def test_forward_matches_jax_twin_and_pallas(n, e, node, edge, layers, seed):
    idx, nodes, edges, ws = _inputs(n, e, node, edge, layers, seed)
    twin = gvp_message_xla(*_jax(idx), *_jax(nodes), *_jax(edges), _jax(ws),
                           layers)
    fused = make_gvp_message_fused(None, n_layers=layers, interpret=True)
    pallas = fused(*_jax(idx), *_jax(nodes), *_jax(edges), *_jax(ws))
    plain = gm.gvp_message_plain(*_torch(idx), *_torch(nodes), *_torch(edges),
                                 _torch(ws), layers)
    before = gm.gvp_message.launches
    wrapped = gm.gvp_message(*_torch(idx), *_torch(nodes), *_torch(edges),
                             *_torch(ws))
    assert gm.gvp_message.launches == before     # the CPU runs no kernel
    for name, p, w, a, b in zip(("s", "vx", "vy", "vz", "cnt"), plain, wrapped,
                                twin, pallas):
        for ref in (a, b):
            np.testing.assert_allclose(p.numpy(), np.asarray(ref),
                                       atol=FWD_ATOL, err_msg=name)
        assert torch.equal(p, w)


def _loss_grads(fn, idx, nodes, edges, ws, cot, argnums):
    """jax.grad of sum(out[:4] * cot) + sum(cnt) in the chosen inputs."""
    def loss(*args):
        out = fn(*args)
        return (sum(jnp.sum(o * c) for o, c in zip(out[:4], cot))
                + jnp.sum(out[4]))
    args = (*_jax(idx), *_jax(nodes), *_jax(edges), *_jax(ws))
    return jax.grad(loss, argnums=argnums)(*args)


@pytest.mark.parametrize("n,e,node,edge,layers,seed", SHAPES)
def test_backward_matches_jax_vjp_and_pallas(n, e, node, edge, layers, seed):
    idx, nodes, edges, ws = _inputs(n, e, node, edge, layers, seed)
    rng = np.random.default_rng(seed + 100)
    cot = [rng.normal(size=(n, d)).astype(np.float32)
           for d in (node[0],) + (node[1],) * 3]
    argnums = tuple(range(3, 11 + len(ws)))       # features and weights

    def twin(*args):
        return gvp_message_xla(*args[:11], list(args[11:]), layers)

    fused = make_gvp_message_fused(None, n_layers=layers, interpret=True,
                                   pallas_bwd=True)
    refs = (_loss_grads(twin, idx, nodes, edges, ws, _jax(cot), argnums),
            _loss_grads(fused, idx, nodes, edges, ws, _jax(cot), argnums))
    hand = gm.gvp_message_bwd_plain(*_torch(idx), *_torch(nodes),
                                    *_torch(edges), _torch(ws), *_torch(cot))
    got = list(hand[:8]) + list(hand[8])
    leaves = [t.requires_grad_() for t in _torch(nodes) + _torch(edges)
              + _torch(ws)]
    out = gm.gvp_message(*_torch(idx), *leaves)
    loss = sum((o * c).sum() for o, c in zip(out[:4], _torch(cot)))
    via_autograd = torch.autograd.grad(loss, leaves)
    assert len(got) == len(via_autograd) == len(refs[0])
    for i, (g, a) in enumerate(zip(got, via_autograd)):
        assert torch.equal(g, a), i
        for ref in refs:
            ref = np.asarray(ref[i])
            scale = max(float(np.abs(ref).max()), 1.0)
            np.testing.assert_allclose(g.numpy(), ref, atol=GRAD_REL * scale,
                                       err_msg=f"input {i}")


def test_masked_and_zero_inputs_give_finite_zero_cotangents():
    """Pad edges are masked zero-length self-loops with zero vectors: their
    cotangents are exactly zero and everything stays finite."""
    idx, nodes, edges, ws = _inputs(12, 40, (8, 2), (4, 1), 3, seed=9)
    send, recv, emask = idx
    emask[30:] = False
    recv[30:] = send[30:]
    for a in edges[1:]:
        a[30:] = 0.0
    for a in nodes[1:]:
        a[:] = 0.0
    cot = _torch([np.ones((12, 8), np.float32)] + [np.ones((12, 2), np.float32)] * 3)
    grads = gm.gvp_message_bwd_plain(*_torch(idx), *_torch(nodes),
                                     *_torch(edges), _torch(ws), *cot)
    for g in list(grads[:8]) + list(grads[8]):
        assert torch.isfinite(g).all()
    for g in grads[4:8]:
        assert torch.equal(g[30:], torch.zeros_like(g[30:]))
    out = gm.gvp_message_plain(*_torch(idx), *_torch(nodes), *_torch(edges),
                               _torch(ws), 3)
    assert all(torch.isfinite(o).all() for o in out)


def test_seg_plans_branch_matches_default():
    """The sorted branch (sender gather through ``sorted_gather``, merged
    receiver sum through ``sorted_segment_sum``) on a receiver-sorted box,
    forward and gradients, against the default branch."""
    batch = bench_scale.box_batch(150, sort=True)
    plans = sss.batch_seg_plans(batch)
    n, e = batch.num_nodes, batch.num_edges
    rng = np.random.default_rng(11)
    _, nodes, edges, ws = _inputs(n, e, (8, 2), (4, 1), 3, seed=11)
    idx = (batch.senders, batch.receivers, batch.edge_mask)
    results = []
    for seg in (None, plans):
        leaves = [t.requires_grad_() for t in _torch(nodes) + _torch(edges)
                  + _torch(ws)]
        out = gm.gvp_message_plain(*idx, *leaves[:8], leaves[8:], 3,
                                   seg_plans=seg)
        cot = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
               for o in out[:4]] if seg is None else cot
        loss = sum((o * c).sum() for o, c in zip(out[:4], cot))
        results.append((out, torch.autograd.grad(loss, leaves)))
    (out_a, grad_a), (out_b, grad_b) = results
    for a, b in zip(out_a, out_b):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    for a, b in zip(grad_a, grad_b):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_chain_dims_and_checks():
    idx, nodes, edges, ws = _inputs(10, 20, (16, 4), (8, 1), 3, seed=1)
    assert gm.chain_dims(_torch(ws)) == [(40, 9, 9, 16, 4), (16, 4, 4, 16, 4),
                                         (16, 4, 4, 16, 4)]
    t = _torch
    # the wrapper's checks: a chain that does not fit the nodes, a message row
    # wider than the kernel takes, float64
    with pytest.raises(ValueError):
        gm._check_cuda_inputs(*t(idx), t(nodes), t(edges), t(ws[6:]))
    with pytest.raises(ValueError):
        gm._check_cuda_inputs(*t(idx), t(nodes), t(edges),
                              [w.double() for w in t(ws)])
    wide = _inputs(10, 20, (250, 4), (8, 1), 1, seed=2)
    with pytest.raises(ValueError):
        gm._check_cuda_inputs(*t(wide[0]), t(wide[1]), t(wide[2]), t(wide[3]))
    assert gm._check_cuda_inputs(*t(idx), t(nodes), t(edges), t(ws)) == \
        gm.chain_dims(t(ws))


def test_relu_margins_are_the_first_gvps_preactivations():
    """With two GVPs the only ReLU is the first GVP's: each live edge's
    margin is its smallest |z|, z = [s_cat, |V Wh|] Ws + bs in float64;
    masked-off edges and a one-GVP chain give inf."""
    idx, nodes, edges, ws = _inputs(15, 50, (8, 2), (4, 1), 2, seed=12)
    send, recv, emask = idx
    f64 = [a.astype(np.float64) for a in nodes + edges + ws]
    (s, *v), (es, *ev), (Wh, _, Ws, bs) = f64[:4], f64[4:8], f64[8:12]
    s_cat = np.concatenate([s[send], es, s[recv]], axis=-1)
    vh = [np.concatenate([a[send], b, a[recv]], axis=-1) @ Wh
          for a, b in zip(v, ev)]
    vn = np.sqrt(np.maximum(sum(p * p for p in vh), 1e-8))
    z = np.concatenate([s_cat, vn], axis=-1) @ Ws + bs
    want = np.where(emask, np.abs(z).min(axis=1), np.inf)
    got = gm.relu_margins(*_torch(idx), _torch(nodes), _torch(edges),
                          _torch(ws))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    one = gm.relu_margins(*_torch(idx), _torch(nodes), _torch(edges),
                          _torch(ws[:6]))
    assert torch.isinf(one).all()


def test_unsupported_device_raises():
    idx, nodes, edges, ws = _inputs(6, 10, (4, 2), (2, 1), 1, seed=3)
    meta = [torch.empty(a.shape, device="meta") for a in nodes]
    with pytest.raises(ValueError):
        gm.gvp_message(*_torch(idx), *meta, *_torch(edges), *_torch(ws))


def test_int32_and_int64_indices_agree():
    idx, nodes, edges, ws = _inputs(10, 30, (8, 2), (4, 1), 2, seed=4)
    a = gm.gvp_message_plain(*_torch(idx), *_torch(nodes), *_torch(edges),
                             _torch(ws), 2)
    idx64 = [torch.from_numpy(i.astype(np.int64)) if i.dtype != bool
             else torch.from_numpy(i) for i in idx]
    b = gm.gvp_message_plain(*idx64, *_torch(nodes), *_torch(edges),
                             _torch(ws), 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_edges,tile", [
    (0, 8), (1, 8), (5, 8),              # no edges, below one tile
    (1400, 8),                           # the star train bucket: 175 blocks
    (16 * 131, 8), (16 * 131 + 1, 16),   # where 16-edge tiles cover the SMs
    (32 * 131, 16), (32 * 131 + 1, 32),  # where 32-edge tiles do
    (4241, 32),                          # not a multiple of the tile
    (129_224, 32)])                      # the unsorted 10k box
def test_tile_rule(n_edges, tile):
    """K5's edge tile on 132 SMs: the largest of 8, 16 and 32 that still
    gives every SM a block."""
    assert gm.gvp_tile(n_edges, 132) == tile
    assert -(-n_edges // tile) >= 132 or tile == 8


def test_tile_rule_takes_only_tiles_that_fit():
    """A tile whose shared memory does not fit is skipped (the backward's
    32-edge tile at full width); with none fitting the tile is 8."""
    assert gm.gvp_tile(129_224, 132, fits=lambda t: t <= 16) == 16
    assert gm.gvp_tile(129_224, 132, fits=lambda t: False) == 8
    assert gm.gvp_tile(129_224, 114) == 32      # fewer SMs
    assert gm.gvp_tile(2000, 114) == 16
