"""The port's EGNN message pass against the JAX package's: the plain version
against ``egnn_message_xla`` and against the Pallas kernel in interpret mode,
the weight packing, the CPU dispatch of the wrapper and the CSR that feeds
the CUDA reduction.  The CUDA kernel itself is held against the plain
version in ``test_torch_cuda.py``, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.models.egnn_fused import (
    FusedEGNNLayer as JaxFusedEGNNLayer)
from geometric_message_passing_tpu.ops.pallas_edge import (
    egnn_message_xla, make_egnn_message_fused)
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops.scatter import segment_sum

ATOL = 1e-5   # f32, same math in another summation order


def _random_inputs(n, e, d, seed, masked=0.1):
    rng = np.random.default_rng(seed)
    return dict(
        send=rng.integers(0, n, e).astype(np.int32),
        recv=rng.integers(0, n, e).astype(np.int32),
        emask=rng.random(e) >= masked,
        h=rng.normal(size=(n, d)).astype(np.float32),
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        w=(rng.normal(size=(edge.msg_rows(d), d)) * 0.1).astype(np.float32),
    )


def _star_inputs(d, seed):
    graphs = jds.create_star_graphs(num=12, fold=(5, 6, 7), seed=seed)
    b = jgraph.batch_graphs(graphs, *jgraph.pad_sizes(graphs, 12))
    rng = np.random.default_rng(seed)
    n = b.num_nodes
    return dict(
        send=np.array(b.senders), recv=np.array(b.receivers),
        emask=np.array(b.edge_mask),
        h=rng.normal(size=(n, d)).astype(np.float32),
        pos=np.array(b.pos),
        w=(rng.normal(size=(edge.msg_rows(d), d)) * 0.1).astype(np.float32),
    )


CASES = {
    "random_40x150x32": lambda: _random_inputs(40, 150, 32, seed=1),
    "star_batch_d32": lambda: _star_inputs(32, seed=0),
}
ORDER = ("send", "recv", "emask", "h", "pos", "w")


def _torch_args(x):
    return tuple(torch.from_numpy(x[k]) for k in ORDER)


def _jax_args(x):
    return tuple(jnp.asarray(x[k]) for k in ORDER)


def _assert_close(got, want, atol=ATOL):
    for g, w, name in zip(got, want, ("msg", "pos", "cnt")):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_twin(case):
    x = CASES[case]()
    d = x["h"].shape[1]
    _assert_close(edge.egnn_message_plain(*_torch_args(x)),
                  egnn_message_xla(*_jax_args(x), d))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    x = CASES[case]()
    d = x["h"].shape[1]
    fused = make_egnn_message_fused(d, interpret=True)
    _assert_close(edge.egnn_message_plain(*_torch_args(x)),
                  fused(*_jax_args(x)))


@pytest.mark.parametrize("d", [16, 32])
def test_pack_matches_jax_layer(d):
    import jax

    n, e = 10, 30
    x = _random_inputs(n, e, d, seed=3)
    layer = JaxFusedEGNNLayer(d)
    variables = layer.init(jax.random.PRNGKey(d), jnp.asarray(x["h"]),
                           jnp.asarray(x["pos"]), jnp.asarray(x["send"]),
                           jnp.asarray(x["recv"]), jnp.asarray(x["emask"]))
    packed = np.asarray(layer.apply(
        variables, jnp.asarray(x["h"]), jnp.asarray(x["pos"]),
        jnp.asarray(x["send"]), jnp.asarray(x["recv"]),
        jnp.asarray(x["emask"]), packed_only=True))
    params = {k: torch.from_numpy(np.array(v))
              for k, v in variables["params"].items()}
    ours = edge.pack_egnn_weights(params).numpy()
    assert ours.shape == (edge.msg_rows(d), d)
    assert np.array_equal(ours, packed[: edge.msg_rows(d)])


def test_wrapper_on_cpu_runs_plain_and_counts_nothing():
    args = _torch_args(_random_inputs(40, 150, 32, seed=4))
    before = edge.egnn_message.launches
    got = edge.egnn_message(*args)
    want = edge.egnn_message_plain(*args)
    assert edge.egnn_message.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _csr_reduce(order, rowptr, msg_e, pos_e, n):
    """What the CUDA reduction does, one node row at a time."""
    d = msg_e.shape[1]
    msg = torch.zeros(n, d)
    pos = torch.zeros(n, 3)
    cnt = torch.zeros(n, 1)
    for i in range(n):
        for k in range(int(rowptr[i]), int(rowptr[i + 1])):
            msg[i] += msg_e[order[k]]
            pos[i] += pos_e[order[k]]
        cnt[i] = rowptr[i + 1] - rowptr[i]
    return msg, pos, cnt


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_receiver_csr_reduces_like_segment_sum(index_dtype):
    rng = np.random.default_rng(5)
    n, e, d = 30, 120, 16
    recv = torch.from_numpy(rng.integers(0, n - 5, e)).to(index_dtype)  # empty rows
    emask = torch.from_numpy(rng.random(e) > 0.25)
    msg_e = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    pos_e = torch.from_numpy(rng.normal(size=(e, 3)).astype(np.float32))
    order, rowptr = edge.receiver_csr(recv, emask, n)
    assert order.dtype == rowptr.dtype == torch.int64
    assert rowptr.shape == (n + 1,) and int(rowptr[-1]) == int(emask.sum())
    for i in range(n):   # each row lists its live edges in ascending order
        row = order[rowptr[i]:rowptr[i + 1]]
        assert (recv[row] == i).all() and emask[row].all()
        assert (row[1:] > row[:-1]).all()
    msg, pos, cnt = _csr_reduce(order, rowptr, msg_e, pos_e, n)
    torch.testing.assert_close(msg, segment_sum(msg_e, recv, n, mask=emask),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(pos, segment_sum(pos_e, recv, n, mask=emask),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(
        cnt, segment_sum(torch.ones(e, 1), recv, n, mask=emask))


@pytest.mark.parametrize("bad", [
    "d_not_multiple_of_16", "d_too_large", "h_float64", "pos_shape",
    "w_shape", "mixed_index_dtypes", "mask_not_bool", "not_contiguous",
])
def test_kernel_input_checks(bad):
    x = _torch_args(_random_inputs(20, 40, 32, seed=6))
    send, recv, emask, h, pos, w = x
    if bad == "d_not_multiple_of_16":
        h, w = h[:, :24].contiguous(), torch.zeros(edge.msg_rows(24), 24)
    elif bad == "d_too_large":
        h, w = torch.zeros(20, 272), torch.zeros(edge.msg_rows(272), 272)
    elif bad == "h_float64":
        h = h.double()
    elif bad == "pos_shape":
        pos = pos[:, :2].contiguous()
    elif bad == "w_shape":
        w = w[:-1]
    elif bad == "mixed_index_dtypes":
        send = send.long()
    elif bad == "mask_not_bool":
        emask = emask.to(torch.uint8)
    elif bad == "not_contiguous":
        h = torch.zeros(32, 20).t()
    with pytest.raises(ValueError):
        edge._check_cuda_inputs(send, recv, emask, h, pos, w)


def test_kernel_input_checks_accept_valid():
    for d in (16, 128, 256):
        x = _random_inputs(20, 40, d, seed=7)
        edge._check_cuda_inputs(*_torch_args(x))
