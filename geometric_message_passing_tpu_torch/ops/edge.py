"""The EGNN message pass and its backward (port of ``ops/pallas_edge.py``'s
fused forward and fused backward kernels).

``egnn_message`` is the public wrapper, differentiable in ``h``, ``pos`` and
the packed weights through ``EGNNMessage``.  For tensors on the CPU it runs
the plain PyTorch versions, ``egnn_message_plain`` forward and
``egnn_message_bwd_plain`` backward; for CUDA tensors it launches the
hand-written kernels ``csrc/egnn_message.cu`` (K1) and
``csrc/egnn_message_bwd.cu`` (K2) or raises — it never falls back.
``egnn_message.launches`` counts the forward calls that launched K1,
``egnn_message.bwd_launches`` the backward calls that launched K2.

Function (per edge e with receiver i = recv[e], sender j = send[e]):
  x = [h_i, h_j, d],  d = |pos_i - pos_j| (0 where the square is <= 1e-24)
  msg = relu(LN(relu(LN(x W1 + b1)) W2 + b2))
  scale = relu(LN(msg P1 + pb1)) . P2 + pb2
and, over masked-in edges, per receiver: sum of msg [N, D], sum of
(pos_i - pos_j) * scale [N, 3] and the edge count [N, 1].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple, Tuple

import torch

from . import _build
from .scatter import segment_sum


def _layernorm_cache(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm returning ``(y, xhat, rstd)`` for the hand-written backward."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    return xhat * gamma + beta, xhat, rstd


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, biased variance."""
    return _layernorm_cache(x, gamma, beta, eps)[0]


def msg_rows(d: int) -> int:
    """Rows of the packed message weights."""
    return 4 * d + 12


def pack_egnn_weights(p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Pack one layer's message/position weights, given by their flax names
    (``msg_w1 [2d+1, d]`` ... ``pos_b2 [1]``), into the ``[4d+12, d]`` row
    layout the kernel reads:
    W1 b1 g1 B1 | W2 b2 g2 B2 | P1 pb1 pg1 pB1 | P2 (laid flat) | pb2 (col 0)."""
    w1 = p["msg_w1"]
    d = w1.shape[1]
    pb2_row = torch.zeros((1, d), dtype=w1.dtype, device=w1.device)
    pb2_row[0, :1] = p["pos_b2"]
    return torch.cat([
        w1, p["msg_b1"][None], p["msg_ln1_scale"][None], p["msg_ln1_bias"][None],
        p["msg_w2"], p["msg_b2"][None], p["msg_ln2_scale"][None],
        p["msg_ln2_bias"][None],
        p["pos_w1"], p["pos_b1"][None], p["pos_ln1_scale"][None],
        p["pos_ln1_bias"][None],
        p["pos_w2"][:, 0][None], pb2_row,
    ], dim=0)


def _unpack(w: torch.Tensor, d: int):
    r = 0
    W1 = w[r : r + 2 * d + 1]; r += 2 * d + 1
    b1, g1, B1 = w[r], w[r + 1], w[r + 2]; r += 3
    W2 = w[r : r + d]; r += d
    b2, g2, B2 = w[r], w[r + 1], w[r + 2]; r += 3
    P1 = w[r : r + d]; r += d
    pb1, pg1, pB1 = w[r], w[r + 1], w[r + 2]; r += 3
    P2 = w[r]; r += 1
    pb2 = w[r, 0]
    return W1, b1, g1, B1, W2, b2, g2, B2, P1, pb1, pg1, pB1, P2, pb2


def _layernorm_bwd(dy, xhat, rstd, gamma):
    """LayerNorm backward: ``(dx, dgamma, dbeta)``."""
    dxhat = dy * gamma
    dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx, (dy * xhat).sum(dim=0), dy.sum(dim=0)


def _edge_geometry(send, recv, pos):
    pd = pos[recv] - pos[send]
    sq = (pd * pd).sum(dim=-1, keepdim=True)
    positive = sq > 1e-24
    dists = torch.where(positive,
                        torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                        torch.zeros_like(sq))
    return pd, positive, dists


def egnn_message_plain(send, recv, emask, h, pos, packed_w
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same math as the JAX package's
    ``egnn_message_xla``)."""
    n, d = h.shape
    (W1, b1, g1, B1, W2, b2, g2, B2,
     P1, pb1, pg1, pB1, P2, pb2) = _unpack(packed_w, d)
    h_j, h_i = h[send], h[recv]
    pos_diff, _, dists = _edge_geometry(send, recv, pos)
    x = torch.cat([h_i, h_j, dists], dim=-1)
    m = torch.relu(layernorm(x @ W1 + b1, g1, B1))
    msg = torch.relu(layernorm(m @ W2 + b2, g2, B2))
    p = torch.relu(layernorm(msg @ P1 + pb1, pg1, pB1))
    scale = p @ P2[:, None] + pb2
    pos_msg = pos_diff * scale

    msg_acc = segment_sum(msg, recv, n, mask=emask)
    pos_acc = segment_sum(pos_msg, recv, n, mask=emask)
    cnt = segment_sum(h.new_ones((send.shape[0], 1)), recv, n, mask=emask)
    return msg_acc, pos_acc, cnt


def egnn_message_bwd_plain(send, recv, emask, h, pos, packed_w, gmsg, gpos
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the cotangents
    ``(dh [N, D], dpos [N, 3], dW [4D+12, D])`` of ``egnn_message``'s first
    two outputs, written out by hand as the JAX package's
    ``_egnn_bwd_kernel`` does (recompute, then back through the scale head,
    the three Linear+LayerNorm+ReLU stages and the gathers).  Masked-off edges
    get a zero cotangent; the count has none."""
    n, d = h.shape
    (W1, b1, g1, B1, W2, b2, g2, B2,
     P1, pb1, pg1, pB1, P2, pb2) = _unpack(packed_w, d)
    send, recv = send.long(), recv.long()
    pd, positive, dists = _edge_geometry(send, recv, pos)
    x = torch.cat([h[recv], h[send], dists], dim=-1)
    y1, xhat1, rstd1 = _layernorm_cache(x @ W1 + b1, g1, B1)
    m = torch.relu(y1)
    y2, xhat2, rstd2 = _layernorm_cache(m @ W2 + b2, g2, B2)
    msg = torch.relu(y2)
    y3, xhat3, rstd3 = _layernorm_cache(msg @ P1 + pb1, pg1, pB1)
    p = torch.relu(y3)
    scale = (p * P2).sum(dim=-1, keepdim=True) + pb2

    live = emask[:, None].to(h.dtype)
    gmsg_out = gmsg[recv] * live            # cotangent at each edge's msg
    gpm = gpos[recv] * live                 # ... and at its pos_msg
    dscale = (gpm * pd).sum(dim=-1, keepdim=True)
    dpd = gpm * scale
    dP2 = (p * dscale).sum(dim=0)
    dpb2 = dscale.sum()
    dz3, dpg1, dpB1 = _layernorm_bwd(dscale * P2 * (y3 > 0), xhat3, rstd3, pg1)
    dmsg = gmsg_out + dz3 @ P1.T
    dz2, dg2, dB2 = _layernorm_bwd(dmsg * (y2 > 0), xhat2, rstd2, g2)
    dz1, dg1, dB1 = _layernorm_bwd((dz2 @ W2.T) * (y1 > 0), xhat1, rstd1, g1)
    dx = dz1 @ W1.T
    inv = torch.where(positive, 1.0 / torch.where(positive, dists,
                                                  torch.ones_like(dists)),
                      torch.zeros_like(dists))
    dpd = dpd + dx[:, 2 * d:] * pd * inv

    dh = h.new_zeros((n, d)).index_add_(0, recv, dx[:, :d])
    dh.index_add_(0, send, dx[:, d:2 * d])
    dpos = dpd.new_zeros((n, 3)).index_add_(0, recv, dpd)
    dpos.index_add_(0, send, -dpd)
    pb2_row = torch.zeros_like(dP2)
    pb2_row[0] = dpb2
    dw = torch.cat([
        x.T @ dz1, dz1.sum(dim=0)[None], dg1[None], dB1[None],
        m.T @ dz2, dz2.sum(dim=0)[None], dg2[None], dB2[None],
        msg.T @ dz3, dz3.sum(dim=0)[None], dpg1[None], dpB1[None],
        dP2[None], pb2_row[None],
    ], dim=0)
    return dh, dpos, dw


def receiver_csr(recv: torch.Tensor, emask: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR of the masked-in edges by receiver: ``order`` lists edge ids
    sorted stably by receiver (masked-off edges sort last), and node ``i``'s
    edges are ``order[rowptr[i]:rowptr[i+1]]``, in ascending edge order.
    Both int64.  ``emask`` None: every edge."""
    key = recv.long() if emask is None else torch.where(
        emask, recv.long(), torch.full_like(recv, n, dtype=torch.long))
    sorted_key, order = torch.sort(key, stable=True)
    nodes = torch.arange(n + 1, device=recv.device, dtype=torch.long)
    rowptr = torch.searchsorted(sorted_key, nodes)
    return order, rowptr


def sender_csr(send: torch.Tensor, emask: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``receiver_csr`` by sender: the same stable sort of the masked-in
    edges, keyed on ``send``."""
    return receiver_csr(send, emask, n)


def _check_cuda_inputs(send, recv, emask, h, pos, packed_w,
                       gmsg=None, gpos=None) -> None:
    dev = h.device
    for name, t in (("send", send), ("recv", recv), ("emask", emask),
                    ("h", h), ("pos", pos), ("packed_w", packed_w),
                    ("gmsg", gmsg), ("gpos", gpos)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"egnn_message: {name} is on {t.device}, h on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"egnn_message: {name} must be contiguous")
    n, d = h.shape
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"egnn_message: D={d} must be a multiple of 16 in [16, 256]")
    for name, t in (("h", h), ("pos", pos), ("packed_w", packed_w),
                    ("gmsg", gmsg), ("gpos", gpos)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"egnn_message: {name} must be float32, got {t.dtype}")
    for name, t, shape in (("pos", pos, (n, 3)), ("gmsg", gmsg, (n, d)),
                           ("gpos", gpos, (n, 3))):
        if t is not None and t.shape != shape:
            raise ValueError(f"egnn_message: {name} shape {tuple(t.shape)} != {shape}")
    if packed_w.shape != (msg_rows(d), d):
        raise ValueError(f"egnn_message: packed_w shape {tuple(packed_w.shape)} "
                         f"!= ({msg_rows(d)}, {d})")
    if packed_w.data_ptr() % 16:
        raise ValueError("egnn_message: packed_w must be 16-byte aligned (the "
                         "kernels copy it in 16-byte pieces)")
    e = send.shape[0]
    if send.dtype not in (torch.int32, torch.int64) or recv.dtype != send.dtype:
        raise ValueError("egnn_message: send/recv must both be int32 or int64")
    if send.shape != (e,) or recv.shape != (e,) or emask.shape != (e,):
        raise ValueError("egnn_message: send, recv and emask must be [E]")
    if emask.dtype != torch.bool:
        raise ValueError(f"egnn_message: emask must be bool, got {emask.dtype}")
    if n >= 2**31 or e >= 2**31:
        raise ValueError("egnn_message: N and E must be below 2**31")


TILES = (8, 16, 32)     # rows of an edge or node tile (csrc/egnn_common.cuh)
SMEM_MAX = 227 * 1024   # dynamic shared memory a block can use


def _row_ld(n: int) -> int:
    """``egnn_common.cuh::row_ld``: a tile's row stride, 4 mod 32 floats."""
    return (n + 27) // 32 * 32 + 4


_HEAD = 16    # the ring's mbarriers and K-tile counts
_SMALL = 12   # per-row scalars


def _ring_floats(tile: int) -> int:
    """``egnn_common.cuh::ring_floats``: 4 K-tiles of 128 columns and 32
    weight rows (16 at tile 32)."""
    return 4 * 128 * (16 if tile >= 32 else 32)


def tile_smem_bytes(tile: int, d: int) -> int:
    """Shared memory of one EGNN tile of ``tile`` rows at width ``d``
    (``egnn_common.cuh::tile_layout``; its C twin is
    ``gmp_egnn_tile_smem``): the head, x rows [tile, row_ld(2d+1)], two rows
    [tile, row_ld(d)], the per-row scalars and the K-tile ring."""
    return 4 * (_HEAD + tile * (_row_ld(2 * d + 1) + 2 * _row_ld(d) + _SMALL)
                + _ring_floats(tile))


def egnn_tile(n_edges: int, sms: int, fits=lambda tile: True) -> int:
    """The tile of K2's edge kernel and of K6 (edges and nodes alike) for
    ``n_edges`` edges on a card of ``sms`` SMs: the largest of ``TILES``
    that still gives every SM an edge tile (``ceil(n_edges / tile) >=
    sms``) and whose shared memory ``fits``; the smallest, 8, when no larger
    one does.  A larger tile reads each staged weight for more rows; a
    smaller one keeps every SM busy on a small batch (the star train bucket,
    1400 edges, keeps 8: 175 edge tiles on 132 SMs; the 10k box takes
    32)."""
    tile = TILES[0]
    for t in TILES[1:]:
        if -(-n_edges // t) >= sms and fits(t):
            tile = t
    return tile


@functools.lru_cache(maxsize=256)
def _tile_for(n_edges: int, d: int, device: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return egnn_tile(n_edges, sms, lambda t: tile_smem_bytes(t, d) <= SMEM_MAX)


def kernel_tile(n_edges: int, d: int, device) -> int:
    """The tile K2 and K6 take for ``n_edges`` edges of width ``d`` on
    ``device`` (``egnn_tile`` with the card's SM count)."""
    dev = torch.device(device)
    return _tile_for(n_edges, d, dev.index if dev.index is not None
                     else torch.cuda.current_device())


# K1's edge kernel keeps the message weights resident in shared memory for
# the whole launch, their columns split over a cluster of blocks
# (csrc/egnn_message.cu); its C twin is gmp_egnn_resident_plan.
CLUSTERS = (1, 2, 4, 8)
_RES_HEAD = 32       # the weight copies' mbarriers (128 bytes)
_RES_BOX_ROWS = 32   # weight rows a bulk tensor copy moves
_RES_MAX_SHARE = 128   # columns a block holds at most
_RES_TILE_COST = 16    # a tile's fixed steps, in rows of products
RESIDENT_TILES = (8, 16, 24, 32, 40)   # rows of an edge tile
RESIDENT_STAMPS = 11   # slots of the edge kernel's clock readings


class ResidentPlan(NamedTuple):
    """How K1's edge kernel runs at width ``d``: ``cluster`` blocks share a
    tile, block r holding the columns ``[sum(shares[:r]), sum(shares[:r+1]))``
    of every weight; tiles of ``tile`` edge rows; ``smem_bytes`` of shared
    memory a block."""
    cluster: int
    shares: Tuple[int, ...]
    tile: int
    smem_bytes: int


def resident_shares(d: int, cluster: int) -> Tuple[int, ...]:
    """``d`` columns over ``cluster`` blocks in multiples of 4, as even as
    can be, the larger shares first."""
    base, extra = divmod(d // 4, cluster)
    return tuple(4 * (base + (r < extra)) for r in range(cluster))


def resident_smem_bytes(d: int, share: int, tile: int) -> int:
    """Shared memory of a block of K1's edge kernel whose widest share is
    ``share`` columns: the head; the share of the packed rows [0, 4d+7)
    (W1 b1 g1 B1 | W2 b2 g2 B2 | P1) rounded up to whole boxes of 32 rows;
    the ten vector rows b1 ... P2, whole [10, d]; per tile row x
    [row_ld(2d+1)], two buffers of whole product rows [row_ld(d) each] and
    two of row scalars (the current tile's; the next tile's ids)."""
    rows = -(-(4 * d + 7) // _RES_BOX_ROWS) * _RES_BOX_ROWS
    return 4 * (_RES_HEAD + rows * share + 10 * d
                + tile * (_row_ld(2 * d + 1) + 2 * _row_ld(d) + 2 * _SMALL))


def resident_plan(d: int, n_edges: int, clusters: int) -> ResidentPlan:
    """K1's plan for ``n_edges`` edges of width ``d`` on a card that holds
    ``clusters`` clusters of the plan's size at once (at 8-row tiles).  The
    cluster is the smallest of ``CLUSTERS`` whose share of the weights fits
    a block beside an 8-row tile (D 16-96: 1; 112-144: 2; 160-208: 4;
    224-256: 8); the tile, of ``RESIDENT_TILES`` that fit, the one with the
    fewest rounds of tiles over the clusters times (rows + 16), the smaller
    on a tie: a tile's gather, row steps and barriers cost about as much as
    16 rows of products (the serving bucket's 1408 edges on 66 clusters of
    2: 24, one round; the 10k box: 40)."""
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"egnn_message: D={d} must be a multiple of 16 in [16, 256]")
    for cluster in CLUSTERS:
        shares = resident_shares(d, cluster)
        if (min(shares) >= 4 and shares[0] <= _RES_MAX_SHARE
                and resident_smem_bytes(d, shares[0], RESIDENT_TILES[0]) <= SMEM_MAX):
            break
    else:
        raise ValueError(f"egnn_message: no cluster holds the weights at D={d}")
    slots = max(clusters, 1)
    tile, best = RESIDENT_TILES[0], None
    for t in RESIDENT_TILES:
        if resident_smem_bytes(d, shares[0], t) > SMEM_MAX:
            continue
        tiles = -(-n_edges // t)
        cost = -(-tiles // slots) * (t + _RES_TILE_COST)   # rounds x rows
        if best is None or cost < best:
            tile, best = t, cost
    return ResidentPlan(cluster, shares, tile,
                        resident_smem_bytes(d, shares[0], tile))


@functools.lru_cache(maxsize=256)
def _resident_clusters(d: int, tile: int, idx64: bool, device: int) -> int:
    """Clusters of K1's edge kernel the card holds at once at ``tile``
    (``cudaOccupancyMaxActiveClusters``); raises when it is 0."""
    lib = _build.load("egnn_message")
    out = ctypes.c_int(0)
    _build.check(lib, lib.gmp_egnn_resident_clusters(
        device, d, tile, int(idx64), ctypes.addressof(out)),
        "egnn edge kernel occupancy")
    return out.value


@functools.lru_cache(maxsize=256)
def _resident_for(n_edges: int, d: int, idx64: bool, device: int
                  ) -> Tuple[ResidentPlan, int]:
    plan = resident_plan(d, n_edges,
                         _resident_clusters(d, RESIDENT_TILES[0], idx64, device))
    return plan, _resident_clusters(d, plan.tile, idx64, device)


def kernel_resident_plan(n_edges: int, d: int, device,
                         idx64: bool = False) -> Tuple[ResidentPlan, int]:
    """The plan K1's edge kernel takes for ``n_edges`` edges of width ``d``
    on ``device``, and the clusters it launches at most (one per tile
    below that)."""
    dev = torch.device(device)
    return _resident_for(n_edges, d, idx64, dev.index if dev.index is not None
                         else torch.cuda.current_device())


def _launch_kernels(send, recv, emask, h, pos, packed_w, order, rowptr,
                    msg_e, pos_e, msg_out, pos_out, cnt_out,
                    stamps=None) -> None:
    """Launch the edge and reduce kernels on the current stream into the
    given buffers (per-edge scratch ``msg_e [E, D]``, ``pos_e [E, 3]``;
    outputs ``[N, D]``, ``[N, 3]``, ``[N, 1]``).  ``stamps`` (int64
    ``[RESIDENT_STAMPS]`` on the card, optional) receives the edge kernel's
    clock readings (``bench_kernels --only k1``)."""
    lib = _build.load("egnn_message")
    n, d = h.shape
    e = send.shape[0]
    dev = h.device.index if h.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    idx64 = send.dtype == torch.int64
    plan, clusters = _resident_for(e, d, idx64, dev)
    _build.check(lib, lib.gmp_egnn_edges(
        dev, send.data_ptr(), recv.data_ptr(), int(idx64),
        emask.data_ptr(), h.data_ptr(), pos.data_ptr(), packed_w.data_ptr(),
        msg_e.data_ptr(), pos_e.data_ptr(), e, d, plan.tile, clusters,
        None if stamps is None else stamps.data_ptr(), stream),
        "egnn edge kernel")
    _build.check(lib, lib.gmp_egnn_reduce(
        dev, order.data_ptr(), rowptr.data_ptr(), msg_e.data_ptr(),
        pos_e.data_ptr(), msg_out.data_ptr(), pos_out.data_ptr(),
        cnt_out.data_ptr(), n, d, stream), "egnn reduce kernel")


def _egnn_message_cuda(send, recv, emask, h, pos, packed_w):
    """K1 on the card; also returns the receiver CSR it built."""
    _check_cuda_inputs(send, recv, emask, h, pos, packed_w)
    n, d = h.shape
    e = send.shape[0]
    f32 = dict(dtype=torch.float32, device=h.device)
    msg_e, pos_e = torch.empty((e, d), **f32), torch.empty((e, 3), **f32)
    msg_out = torch.empty((n, d), **f32)
    pos_out = torch.empty((n, 3), **f32)
    cnt_out = torch.empty((n, 1), **f32)
    order, rowptr = receiver_csr(recv, emask, n)
    _launch_kernels(send, recv, emask, h, pos, packed_w, order, rowptr,
                    msg_e, pos_e, msg_out, pos_out, cnt_out)
    egnn_message.launches += 1
    return (msg_out, pos_out, cnt_out), (order, rowptr)


# the weight gradients' sums run over slices of rows, each summed in order
# by one block: at most BWD_MAX_SLICES slices of a multiple of 128 rows
BWD_MAX_SLICES = 64


def bwd_split(rows: int) -> int:
    """Rows per slice of K2's and K6's weight-gradient sums over ``rows``
    edges (or nodes): 128, or the next multiple of 128 that keeps the
    slices at most ``BWD_MAX_SLICES`` (the star train bucket's 1400 edges:
    11 slices of 128; the 10k box's 129,280: 64 of 2048).  Short slices
    give a small batch's sums enough blocks; the cap bounds the partial
    sums a large one keeps and adds."""
    return 128 * max(1, -(-rows // (128 * BWD_MAX_SLICES)))


def act_edge_ld(d: int) -> int:
    """Floats of one edge's kept forward activations (xhat of the three
    LayerNorms, their rstd, the scale head's value)."""
    return 3 * d + 4


def bwd_scratch(n: int, e: int, d: int, device) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' scratch: the transposed weight blocks ``[4, D,
    D]`` (P1, W2, W1's two halves); per edge the forward's kept activations
    ``[E, 3D+4]``, ``ops [E, 15D+4]``, ``dh_i``, ``dh_j [E, D]``, ``dpd [E,
    3]``; per slice of ``bwd_split(E)`` edges a partial ``dW`` (``[slices,
    4D+12, D]``); and the outputs ``dh [N, D]``, ``dpos [N, 3]``, ``dW
    [4D+12, D]``."""
    f32 = dict(dtype=torch.float32, device=device)
    slices = max(1, -(-e // bwd_split(e)))
    return tuple(torch.empty(shape, **f32) for shape in (
        (4, d, d), (e, act_edge_ld(d)), (e, 15 * d + 4), (e, d), (e, d), (e, 3),
        (slices, msg_rows(d), d), (n, d), (n, 3), (msg_rows(d), d)))


def _launch_bwd_kernels(send, recv, emask, h, pos, packed_w, gmsg, gpos,
                        recv_csr, send_csr, scratch) -> None:
    """Launch K2's five kernels on the current stream (``scratch`` from
    ``bwd_scratch``; its last three tensors receive dh, dpos and dW) at the
    tile ``kernel_tile`` picks."""
    lib = _build.load("egnn_message_bwd")
    n, d = h.shape
    e = send.shape[0]
    dev = h.device.index if h.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.check(lib, lib.gmp_egnn_bwd(
        dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
        emask.data_ptr(), h.data_ptr(), pos.data_ptr(), packed_w.data_ptr(),
        gmsg.data_ptr(), gpos.data_ptr(), *(t.data_ptr() for t in recv_csr),
        *(t.data_ptr() for t in send_csr), *(t.data_ptr() for t in scratch),
        n, e, d, bwd_split(e), kernel_tile(e, d, h.device), stream),
        "egnn backward kernels")


def _egnn_message_bwd_cuda(send, recv, emask, h, pos, packed_w, gmsg, gpos,
                           recv_csr=None):
    gmsg, gpos = gmsg.contiguous(), gpos.contiguous()
    _check_cuda_inputs(send, recv, emask, h, pos, packed_w, gmsg, gpos)
    n, d = h.shape
    if recv_csr is None:
        recv_csr = receiver_csr(recv, emask, n)
    scratch = bwd_scratch(n, send.shape[0], d, h.device)
    _launch_bwd_kernels(send, recv, emask, h, pos, packed_w, gmsg, gpos,
                        recv_csr, sender_csr(send, emask, n), scratch)
    egnn_message.bwd_launches += 1
    return scratch[-3:]


def egnn_message_bwd(send, recv, emask, h, pos, packed_w, gmsg, gpos,
                     recv_csr=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dh, dpos, dW)``: the cotangents of ``egnn_message``'s inputs given
    those of its first two outputs, ``gmsg [N, D]`` and ``gpos [N, 3]``.
    CPU tensors take ``egnn_message_bwd_plain``, CUDA tensors the kernel,
    which reuses ``recv_csr`` (``receiver_csr``'s result) when given."""
    if h.device.type == "cpu":
        return egnn_message_bwd_plain(send, recv, emask, h, pos, packed_w,
                                      gmsg, gpos)
    if h.device.type != "cuda":
        raise ValueError(f"egnn_message: unsupported device {h.device}")
    return _egnn_message_bwd_cuda(send, recv, emask, h, pos, packed_w, gmsg,
                                  gpos, recv_csr)


class EGNNMessage(torch.autograd.Function):
    """``egnn_message`` with its hand-written backward (the JAX package's
    ``custom_vjp`` around the fused kernels).  The count output has no
    gradient; a missing cotangent counts as zero."""

    @staticmethod
    def forward(ctx, send, recv, emask, h, pos, packed_w):
        csr = ()
        if h.device.type == "cpu":
            out = egnn_message_plain(send, recv, emask, h, pos, packed_w)
        elif h.device.type == "cuda":
            out, csr = _egnn_message_cuda(send, recv, emask, h, pos, packed_w)
        else:
            raise ValueError(f"egnn_message: unsupported device {h.device}")
        ctx.save_for_backward(send, recv, emask, h, pos, packed_w, *csr)
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, gmsg, gpos, _gcnt):
        send, recv, emask, h, pos, packed_w, *csr = ctx.saved_tensors
        if gmsg is None:
            gmsg = torch.zeros_like(h)
        if gpos is None:
            gpos = torch.zeros_like(pos)
        grads = egnn_message_bwd(send, recv, emask, h, pos, packed_w, gmsg,
                                 gpos, tuple(csr) or None)
        return (None, None, None) + tuple(grads)


def egnn_message(send, recv, emask, h, pos, packed_w
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-receiver sums of EGNN messages, position messages and edge counts:
    ``[N, D]``, ``[N, 3]``, ``[N, 1]``; differentiable in ``h``, ``pos`` and
    ``packed_w``.

    ``send``/``recv`` int32 or int64 ``[E]``, ``emask`` bool ``[E]``,
    ``h`` f32 ``[N, D]``, ``pos`` f32 ``[N, 3]``, ``packed_w`` f32
    ``[4D+12, D]`` (``pack_egnn_weights``).  Every edge's indices must lie in
    ``[0, N)`` on the CPU, masked-in edges' on the card.  CPU tensors take
    the plain versions; CUDA tensors take the kernels (D a multiple of 16 in
    [16, 256], contiguous inputs on one device), launched on the current
    stream without synchronising."""
    return EGNNMessage.apply(send, recv, emask, h, pos, packed_w)


egnn_message.launches = 0
egnn_message.bwd_launches = 0
