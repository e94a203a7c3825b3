"""The GVP-GNN message pass and its backward (port of ``ops/pallas_gvp.py``).

``gvp_message`` is the public wrapper, differentiable in the node and edge
features and the weights through ``GVPMessage``.  For tensors on the CPU it
runs the plain PyTorch versions, ``gvp_message_plain`` forward and
``gvp_message_bwd_plain`` backward; for CUDA tensors it launches the
hand-written kernels ``csrc/gvp_message.cu`` (K5 forward) and
``csrc/gvp_message_bwd.cu`` (K5 backward) or raises: it never falls back.
``gvp_message.launches`` counts the forward calls that launched the forward
kernel, ``gvp_message.bwd_launches`` the backward calls that launched the
backward kernels.

Function (per edge e with sender j = send[e], receiver i = recv[e]): the
chain input is ``(s_j, V_j)``, the edge features and ``(s_i, V_i)``
concatenated; vector channels travel as three component planes
``vx, vy, vz [*, nv]``.  ``gvp_chain`` runs the GVPs on it (weights per GVP
``Wh [vi, h], Wv [h, vo], Ws [si+h, so], bs [so] or [1, so], Wsv [so, vo],
bsv [vo] or [1, vo]``, flat in that order, GVP after GVP).  Over masked-in
edges, per receiver: the sums of the chain's scalar and three plane outputs
and the edge count.  Mean aggregation divides by ``max(count, 1)`` at the
caller.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .edge import receiver_csr, sender_csr
from .scatter import segment_sum
from .sorted_segsum import SegmentPlan, sorted_gather, sorted_segment_sum

N_W = 6            # weights per GVP: Wh, Wv, Ws, bs, Wsv, bsv
NORM_EPS = 1e-8    # norm_no_nan's clip of the squared norm


def gvp_chain(s, vx, vy, vz, weights: Sequence[torch.Tensor], n_layers: int,
              pre_relu: Optional[list] = None):
    """The GVP chain on component planes: ``nn.gvp.GVP`` with the vector
    gate, ReLU/sigmoid activations and a linear last GVP, the squared norm
    clipped at 1e-8.  The three planes are stacked row-wise for the vector
    products, as the JAX package does.  ``pre_relu``: a list that receives
    each ReLU's input ``[E, so]`` (every GVP but the last)."""
    for k in range(n_layers):
        Wh, Wv, Ws, bs, Wsv, bsv = weights[k * N_W:(k + 1) * N_W]
        last = k == n_layers - 1
        e = s.shape[0]
        vh_all = torch.cat([vx, vy, vz], dim=0) @ Wh
        vhx, vhy, vhz = vh_all[:e], vh_all[e:2 * e], vh_all[2 * e:]
        vn = torch.sqrt(torch.clamp_min(vhx * vhx + vhy * vhy + vhz * vhz,
                                        NORM_EPS))
        spre = torch.cat([s, vn], dim=-1) @ Ws + bs
        gate_in = spre if last else torch.sigmoid(spre)
        g = torch.sigmoid(gate_in @ Wsv + bsv)
        v_all = (vh_all @ Wv) * torch.cat([g, g, g], dim=0)
        vx, vy, vz = v_all[:e], v_all[e:2 * e], v_all[2 * e:]
        if not last and pre_relu is not None:
            pre_relu.append(spre)
        s = spre if last else torch.relu(spre)
    return s, vx, vy, vz


def relu_margins(send, recv, emask, nodes, edges,
                 weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each edge's smallest ``|z|`` over the chain's ReLU pre-activations,
    from a float64 run on the inputs' device: ``[E]`` float64, ``inf`` on
    masked-off edges and for a one-GVP chain.  ``nodes`` are ``(s, vx, vy,
    vz)``, ``edges`` ``(es, evx, evy, evz)``.  A pre-activation within f32
    rounding of zero may take its ReLU mask one way in the kernel and the
    other in the plain version; this finds the edges where that can
    happen."""
    zs = []
    gvp_chain(*_chain_input(send.long(), recv.long(),
                            *(t.double() for t in (*nodes, *edges))),
              [w.double() for w in weights], len(weights) // N_W, zs)
    margin = torch.full((send.shape[0],), float("inf"), dtype=torch.float64,
                        device=send.device)
    for z in zs:
        margin = torch.minimum(margin, z.abs().amin(dim=1))
    return margin.masked_fill(~emask, float("inf"))


def _chain_input(send, recv, s, vx, vy, vz, es, evx, evy, evz, f_j=None):
    """The chain input ``[s_j, es, s_i]`` and its three planes; ``f_j``
    (the senders' ``[s | vx | vy | vz]`` rows) when already gathered."""
    so, nv = s.shape[1], vx.shape[1]
    feat = torch.cat([s, vx, vy, vz], dim=-1)
    if f_j is None:
        f_j = feat[send]
    f_i = feat[recv]

    def plane(f, k):
        return f[:, so + k * nv: so + (k + 1) * nv]

    s_cat = torch.cat([f_j[:, :so], es, f_i[:, :so]], dim=-1)
    planes = [torch.cat([plane(f_j, k), ev, plane(f_i, k)], dim=-1)
              for k, ev in enumerate((evx, evy, evz))]
    return (s_cat, *planes)


def gvp_message_plain(send, recv, emask, s, vx, vy, vz, es, evx, evy, evz,
                      weights: Sequence[torch.Tensor], n_layers: int,
                      seg_plans: Optional[Dict[str, SegmentPlan]] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel (the JAX package's
    ``gvp_message_xla``): ``(s_sum [N, so], vx_sum, vy_sum, vz_sum [N, vo],
    cnt [N, 1])``.

    ``seg_plans`` (``ops.sorted_segsum.batch_seg_plans``): the senders'
    gather goes through ``sorted_gather`` on the ``'snd'`` plan and the
    merged ``[E, so + 3 vo + 1]`` receiver sum through ``sorted_segment_sum``
    on the ``'rcv'`` plan (the sorted segment-sum kernel on the card, for
    the sum and for the gather's backward)."""
    n = s.shape[0]
    f_j = None
    if seg_plans is not None:
        feat = torch.cat([s, vx, vy, vz], dim=-1)
        f_j = sorted_gather(feat, send, seg_plans["snd"], emask)
    chain_in = _chain_input(send, recv, s, vx, vy, vz, es, evx, evy, evz, f_j)
    ms, mvx, mvy, mvz = gvp_chain(*chain_in, list(weights), n_layers)
    ones = ms.new_ones((send.shape[0], 1))
    m_all = torch.cat([ms, mvx, mvy, mvz, ones], dim=-1)
    if seg_plans is not None:
        r = sorted_segment_sum(m_all, seg_plans["rcv"], recv, emask)
    else:
        r = segment_sum(m_all, recv, n, mask=emask)
    mo, wv = ms.shape[1], mvx.shape[1]
    return (r[:, :mo], r[:, mo:mo + wv], r[:, mo + wv:mo + 2 * wv],
            r[:, mo + 2 * wv:mo + 3 * wv], r[:, mo + 3 * wv:])


def gvp_message_bwd_plain(send, recv, emask, s, vx, vy, vz, es, evx, evy, evz,
                          weights: Sequence[torch.Tensor], gs, gvx, gvy, gvz
                          ) -> Tuple:
    """Plain PyTorch version of the backward kernel: the cotangents
    ``(ds, dvx, dvy, dvz, des, devx, devy, devz, dweights)`` of
    ``gvp_message``'s inputs given those of its first four outputs, written
    out by hand as the kernel computes them: recompute the chain, then back
    through each GVP's gate (two sigmoids), ReLU, clipped norm (no gradient
    where the squared norm is at most 1e-8) and products, and through the
    concatenation and the gathers.  Masked-off edges get a zero cotangent;
    the count has none.  ``dweights`` is a list shaped like ``weights``."""
    n_layers = len(weights) // N_W
    send, recv = send.long(), recv.long()
    e = send.shape[0]
    s_cat, cx, cy, cz = _chain_input(send, recv, s, vx, vy, vz, es, evx, evy,
                                     evz)
    x_s, v_all = s_cat, torch.cat([cx, cy, cz], dim=0)
    cache = []
    for k in range(n_layers):
        Wh, Wv, Ws, bs, Wsv, bsv = weights[k * N_W:(k + 1) * N_W]
        last = k == n_layers - 1
        vh = v_all @ Wh
        q = vh[:e] ** 2 + vh[e:2 * e] ** 2 + vh[2 * e:] ** 2
        vn = torch.sqrt(torch.clamp_min(q, NORM_EPS))
        x = torch.cat([x_s, vn], dim=-1)
        z = x @ Ws + bs
        vo = vh @ Wv
        gi = z if last else torch.sigmoid(z)
        g = torch.sigmoid(gi @ Wsv + bsv)
        cache.append((v_all, vh, q, vn, x, z, vo, gi, g))
        v_all = vo * torch.cat([g, g, g], dim=0)
        x_s = z if last else torch.relu(z)

    live = emask[:, None].to(s.dtype)
    d_s = gs[recv] * live
    d_v = torch.cat([gvx[recv] * live, gvy[recv] * live, gvz[recv] * live])
    dweights = [None] * len(weights)
    for k in reversed(range(n_layers)):
        Wh, Wv, Ws, bs, Wsv, bsv = weights[k * N_W:(k + 1) * N_W]
        last = k == n_layers - 1
        v_in, vh, q, vn, x, z, vo, gi, g = cache[k]
        g3 = torch.cat([g, g, g], dim=0)
        dvo = d_v * g3
        dg = (d_v * vo).reshape(3, e, vo.shape[1]).sum(dim=0)
        da = dg * g * (1.0 - g)
        if last:
            dz = d_s + da @ Wsv.T
        else:
            dz = d_s * (z > 0) + (da @ Wsv.T) * gi * (1.0 - gi)
        dx = dz @ Ws.T
        h = vh.shape[1]
        ds_in, dvn = dx[:, :-h], dx[:, -h:]
        coef = torch.where(q > NORM_EPS, dvn / vn, torch.zeros_like(vn))
        dvh = dvo @ Wv.T + vh * torch.cat([coef, coef, coef], dim=0)
        dweights[k * N_W:(k + 1) * N_W] = [
            (v_in.T @ dvh).reshape(Wh.shape), (vh.T @ dvo).reshape(Wv.shape),
            (x.T @ dz).reshape(Ws.shape), dz.sum(dim=0).reshape(bs.shape),
            (gi.T @ da).reshape(Wsv.shape), da.sum(dim=0).reshape(bsv.shape)]
        d_s, d_v = ds_in, dvh @ Wh.T

    so, nv = s.shape[1], vx.shape[1]
    se, ve = es.shape[1], evx.shape[1]
    planes = d_v.reshape(3, e, d_v.shape[1])
    des = d_s[:, so:so + se]
    dev = [p[:, nv:nv + ve] for p in planes]
    d_j = torch.cat([d_s[:, :so], *(p[:, :nv] for p in planes)], dim=-1)
    d_i = torch.cat([d_s[:, so + se:], *(p[:, nv + ve:] for p in planes)], dim=-1)
    d_feat = d_j.new_zeros((s.shape[0], so + 3 * nv))
    d_feat.index_add_(0, recv, d_i).index_add_(0, send, d_j)
    ds, dvx, dvy, dvz = d_feat.split([so, nv, nv, nv], dim=-1)
    return (ds, dvx, dvy, dvz, des, *dev, dweights)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

MAX_LAYERS = 8          # GVPs in one chain (csrc/gvp_common.cuh)
MAX_SCALAR = 256        # each GVP's scalar output width
MAX_VECTOR = 128        # each GVP's vector widths vi, h, vo
MAX_ROW = 256           # node row S + 3V and the message row so + 3 vo
# edges per slice of the backward's weight-gradient sums (a multiple of 32)
BWD_SPLIT_EDGES = 512
TILES = (8, 16, 32)     # edge tiles of the edge kernels (csrc/gvp_common.cuh)
SMEM_MAX = 227 * 1024   # dynamic shared memory a block can use


def gvp_tile(n_edges: int, sms: int, fits=lambda tile: True) -> int:
    """K5's edge tile for ``n_edges`` edges on a card of ``sms`` SMs: the
    largest of ``TILES`` that still gives every SM a block (``ceil(n_edges /
    tile) >= sms``) and whose shared memory ``fits``; the smallest, 8, when
    no larger one does.  A larger tile reads each staged weight for more
    edges; a smaller one keeps every SM busy on a small batch (the star train
    bucket, 1400 edges, keeps 8: 175 blocks on 132 SMs; the 10k box takes
    the largest that fits)."""
    tile = TILES[0]
    for t in TILES[1:]:
        if -(-n_edges // t) >= sms and fits(t):
            tile = t
    return tile


@functools.lru_cache(maxsize=256)
def _tile_for(source: str, dims: tuple, n_edges: int, device: int) -> int:
    """``gvp_tile`` on card ``device`` with the shared memory the kernel of
    ``source`` (``gvp_message`` or ``gvp_message_bwd``) needs at each tile
    (its ``gmp_gvp_{fwd,bwd}_smem``).  Cached: a model calls the same
    shapes again and again."""
    lib = _build.load(source)
    smem_fn = (lib.gmp_gvp_fwd_smem if source == "gvp_message"
               else lib.gmp_gvp_bwd_smem)
    arr = _dims_array(dims)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return gvp_tile(n_edges, sms, lambda t: 0 < smem_fn(
        ctypes.addressof(arr), len(dims), t) <= SMEM_MAX)


def chain_dims(weights: Sequence[torch.Tensor]) -> list:
    """``(si, vi, h, so, vo)`` of each GVP, read from its weights' shapes."""
    dims = []
    for k in range(len(weights) // N_W):
        Wh, Wv, Ws, bs, Wsv, bsv = weights[k * N_W:(k + 1) * N_W]
        vi, h = Wh.shape
        so = Ws.shape[1]
        dims.append((Ws.shape[0] - h, vi, h, so, Wv.shape[1]))
    return dims


def _check_cuda_inputs(send, recv, emask, nodes, edges, weights,
                       cots=()) -> list:
    """Raise on what the kernels do not take; returns ``chain_dims``."""
    s, vx = nodes[0], nodes[1]
    es, evx = edges[0], edges[1]
    dev = s.device
    named = ([("send", send), ("recv", recv), ("emask", emask)]
             + list(zip(("s", "vx", "vy", "vz"), nodes))
             + list(zip(("es", "evx", "evy", "evz"), edges))
             + [(f"weights[{i}]", w) for i, w in enumerate(weights)]
             + list(zip(("gs", "gvx", "gvy", "gvz"), cots)))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"gvp_message: {name} is on {t.device}, s on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"gvp_message: {name} must be contiguous")
        if t.is_floating_point() and t.dtype != torch.float32:
            raise ValueError(f"gvp_message: {name} must be float32, got {t.dtype}")
    n, S = s.shape
    V = vx.shape[1]
    e, SE = es.shape
    VE = evx.shape[1]
    for name, t, shape in zip(("vx", "vy", "vz", "evx", "evy", "evz"),
                              (*nodes[1:], *edges[1:]),
                              ((n, V),) * 3 + ((e, VE),) * 3):
        if t.shape != shape:
            raise ValueError(f"gvp_message: {name} shape {tuple(t.shape)} != {shape}")
    if send.dtype not in (torch.int32, torch.int64) or recv.dtype != send.dtype:
        raise ValueError("gvp_message: send/recv must both be int32 or int64")
    if send.shape != (e,) or recv.shape != (e,) or emask.shape != (e,):
        raise ValueError("gvp_message: send, recv and emask must be [E]")
    if emask.dtype != torch.bool:
        raise ValueError(f"gvp_message: emask must be bool, got {emask.dtype}")
    if n >= 2**31 or e >= 2**31:
        raise ValueError("gvp_message: N and E must be below 2**31")
    n_layers, rest = divmod(len(weights), N_W)
    if rest or not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"gvp_message: {len(weights)} weights are not 6 per "
                         f"GVP for 1 to {MAX_LAYERS} GVPs")
    dims = chain_dims(weights)
    prev = (2 * S + SE, 2 * V + VE)
    for k, (si, vi, h, so, vo) in enumerate(dims):
        Wh, Wv, Ws, bs, Wsv, bsv = weights[k * N_W:(k + 1) * N_W]
        want = {"Wv": (Wv.shape, (h, vo)), "Ws": (Ws.shape, (si + h, so)),
                "bs": (bs.numel(), so), "Wsv": (Wsv.shape, (so, vo)),
                "bsv": (bsv.numel(), vo)}
        for name, (got, need) in want.items():
            got = tuple(got) if isinstance(got, torch.Size) else got
            if got != need:
                raise ValueError(f"gvp_message: GVP {k} {name} has shape {got}, "
                                 f"expected {need}")
        if (si, vi) != prev:
            raise ValueError(f"gvp_message: GVP {k} takes ({si}, {vi}), the "
                             f"chain gives {prev}")
        if not (1 <= so <= MAX_SCALAR and 1 <= min(vi, h, vo)
                and max(vi, h, vo) <= MAX_VECTOR):
            raise ValueError(f"gvp_message: GVP {k} widths {(si, vi, h, so, vo)} "
                             f"outside so <= {MAX_SCALAR}, 1 <= vi, h, vo <= "
                             f"{MAX_VECTOR}")
        prev = (so, vo)
    so, vo = prev
    if S + 3 * V > MAX_ROW or so + 3 * vo > MAX_ROW or V < 1:
        raise ValueError(f"gvp_message: node row S + 3V = {S + 3 * V} and "
                         f"message row so + 3vo = {so + 3 * vo} must lie in "
                         f"[4, {MAX_ROW}]")
    for name, t, shape in zip(("gs", "gvx", "gvy", "gvz"), cots,
                              ((n, so), (n, vo), (n, vo), (n, vo))):
        if t.shape != shape:
            raise ValueError(f"gvp_message: {name} shape {tuple(t.shape)} != {shape}")
    return dims


def kernel_tiles(weights: Sequence[torch.Tensor], n_edges: int,
                 device) -> Tuple[int, int]:
    """The edge tiles (forward, backward) K5 takes for ``n_edges`` edges of
    this chain on ``device`` (``gvp_tile`` with the kernels' shared
    memory)."""
    dims = tuple(chain_dims(weights))
    dev = torch.device(device)
    dev = dev.index if dev.index is not None else torch.cuda.current_device()
    return (_tile_for("gvp_message", dims, n_edges, dev),
            _tile_for("gvp_message_bwd", dims, n_edges, dev))


def _flat(weights) -> torch.Tensor:
    return torch.cat([w.reshape(-1) for w in weights])


def _dims_array(dims) -> ctypes.Array:
    flat = [x for d in dims for x in d]
    return (ctypes.c_int * len(flat))(*flat)


def _device_and_stream(t: torch.Tensor):
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def launch_fwd(send, recv, emask, nodes, edges, w_flat, dims, csr,
               outs) -> torch.Tensor:
    """Launch the forward kernels on the current stream into ``outs``
    (``[N, so]``, 3 x ``[N, vo]``, ``[N, 1]``); returns the per-edge scratch.
    No checks and no count: ``gvp_message`` and the timing code call it."""
    lib = _build.load("gvp_message")
    s, vx = nodes[0], nodes[1]
    es, evx = edges[0], edges[1]
    so, vo = dims[-1][3], dims[-1][4]
    e = send.shape[0]
    m_e = torch.empty((e, so + 3 * vo), dtype=torch.float32, device=s.device)
    arr = _dims_array(dims)
    dev, stream = _device_and_stream(s)
    tile = _tile_for("gvp_message", tuple(dims), e, dev)
    _build.check(lib, lib.gmp_gvp_fwd(
        dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
        emask.data_ptr(), *(t.data_ptr() for t in nodes),
        *(t.data_ptr() for t in edges), w_flat.data_ptr(), ctypes.addressof(arr),
        len(dims), s.shape[1], vx.shape[1], es.shape[1], evx.shape[1], e,
        s.shape[0], *(t.data_ptr() for t in csr), m_e.data_ptr(),
        *(t.data_ptr() for t in outs), tile, stream), "gvp forward kernels")
    return m_e


def _gvp_message_cuda(send, recv, emask, nodes, edges, weights):
    """K5's forward on the card; also returns the receiver CSR it built."""
    dims = _check_cuda_inputs(send, recv, emask, nodes, edges, weights)
    n = nodes[0].shape[0]
    so, vo = dims[-1][3], dims[-1][4]
    f32 = dict(dtype=torch.float32, device=nodes[0].device)
    outs = (torch.empty((n, so), **f32), torch.empty((n, vo), **f32),
            torch.empty((n, vo), **f32), torch.empty((n, vo), **f32),
            torch.empty((n, 1), **f32))
    csr = receiver_csr(recv, emask, n)
    launch_fwd(send, recv, emask, nodes, edges, _flat(weights), dims, csr, outs)
    gvp_message.launches += 1
    return outs, csr


def bwd_buffers(send, nodes, edges, weights, dims) -> dict:
    """The backward kernels' scratch and outputs: per edge ``ops`` (the
    weight-gradient operands), ``dnj``/``dni [E, S + 3V]``; per slice of
    ``BWD_SPLIT_EDGES`` edges a partial flat dW; the node cotangents, the
    edge cotangents and the flat dW."""
    lib = _build.load("gvp_message_bwd")
    arr = _dims_array(dims)
    width = lib.gmp_gvp_ops_width(ctypes.addressof(arr), len(dims))
    if width <= 0:
        raise ValueError(f"gvp_message: bad chain dims {dims}")
    e = send.shape[0]
    n, S = nodes[0].shape
    V = nodes[1].shape[1]
    size = sum(w.numel() for w in weights)
    slices = max(1, -(-e // BWD_SPLIT_EDGES))
    f32 = dict(dtype=torch.float32, device=nodes[0].device)
    return dict(
        ops=torch.empty((e, width), **f32),
        dnj=torch.empty((e, S + 3 * V), **f32),
        dni=torch.empty((e, S + 3 * V), **f32),
        part=torch.empty((slices, size), **f32),
        dnodes=tuple(torch.empty(t.shape, **f32) for t in nodes),
        dedges=tuple(torch.empty(t.shape, **f32) for t in edges),
        dw=torch.empty((size,), **f32))


def launch_bwd(send, recv, emask, nodes, edges, w_flat, dims, cots,
               recv_csr, send_csr, bufs) -> None:
    """Launch K5's backward kernels on the current stream into ``bufs``
    (``bwd_buffers``).  No checks and no count."""
    lib = _build.load("gvp_message_bwd")
    s, vx = nodes[0], nodes[1]
    es, evx = edges[0], edges[1]
    arr = _dims_array(dims)
    dev, stream = _device_and_stream(s)
    tile = _tile_for("gvp_message_bwd", tuple(dims), send.shape[0], dev)
    _build.check(lib, lib.gmp_gvp_bwd(
        dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
        emask.data_ptr(), *(t.data_ptr() for t in nodes),
        *(t.data_ptr() for t in edges), w_flat.data_ptr(), ctypes.addressof(arr),
        len(dims), s.shape[1], vx.shape[1], es.shape[1], evx.shape[1],
        send.shape[0], s.shape[0], *(t.data_ptr() for t in cots),
        *(t.data_ptr() for t in recv_csr), *(t.data_ptr() for t in send_csr),
        bufs["ops"].data_ptr(), bufs["dnj"].data_ptr(), bufs["dni"].data_ptr(),
        bufs["part"].data_ptr(), *(t.data_ptr() for t in bufs["dnodes"]),
        *(t.data_ptr() for t in bufs["dedges"]), bufs["dw"].data_ptr(),
        BWD_SPLIT_EDGES, tile, stream), "gvp backward kernels")


def _gvp_message_bwd_cuda(send, recv, emask, nodes, edges, weights, cots,
                          recv_csr=None):
    cots = tuple(c.contiguous() for c in cots)
    dims = _check_cuda_inputs(send, recv, emask, nodes, edges, weights, cots)
    n = nodes[0].shape[0]
    if recv_csr is None:
        recv_csr = receiver_csr(recv, emask, n)
    bufs = bwd_buffers(send, nodes, edges, weights, dims)
    launch_bwd(send, recv, emask, nodes, edges, _flat(weights), dims, cots,
               recv_csr, sender_csr(send, emask, n), bufs)
    gvp_message.bwd_launches += 1
    dws = [d.reshape(w.shape) for d, w in
           zip(bufs["dw"].split([w.numel() for w in weights]), weights)]
    return (*bufs["dnodes"], *bufs["dedges"], dws)


def gvp_message_bwd(send, recv, emask, s, vx, vy, vz, es, evx, evy, evz,
                    weights, gs, gvx, gvy, gvz, recv_csr=None) -> Tuple:
    """``(ds, dvx, dvy, dvz, des, devx, devy, devz, dweights)``: the
    cotangents of ``gvp_message``'s inputs given those of its first four
    outputs.  CPU tensors take ``gvp_message_bwd_plain``, CUDA tensors the
    kernels, which reuse ``recv_csr`` (``receiver_csr``'s result) when
    given."""
    if s.device.type == "cpu":
        return gvp_message_bwd_plain(send, recv, emask, s, vx, vy, vz, es, evx,
                                     evy, evz, weights, gs, gvx, gvy, gvz)
    if s.device.type != "cuda":
        raise ValueError(f"gvp_message: unsupported device {s.device}")
    return _gvp_message_bwd_cuda(send, recv, emask, (s, vx, vy, vz),
                                 (es, evx, evy, evz), list(weights),
                                 (gs, gvx, gvy, gvz), recv_csr)


class GVPMessage(torch.autograd.Function):
    """``gvp_message`` with its hand-written backward (the JAX package's
    ``custom_vjp`` around the fused kernels).  The count output has no
    gradient; a missing cotangent counts as zero."""

    @staticmethod
    def forward(ctx, send, recv, emask, s, vx, vy, vz, es, evx, evy, evz, *ws):
        csr = ()
        if s.device.type == "cpu":
            out = tuple(t.contiguous() for t in gvp_message_plain(
                send, recv, emask, s, vx, vy, vz, es, evx, evy, evz, ws,
                len(ws) // N_W))
        elif s.device.type == "cuda":
            out, csr = _gvp_message_cuda(send, recv, emask, (s, vx, vy, vz),
                                         (es, evx, evy, evz), list(ws))
        else:
            raise ValueError(f"gvp_message: unsupported device {s.device}")
        ctx.save_for_backward(send, recv, emask, s, vx, vy, vz, es, evx, evy,
                              evz, *ws, *csr)
        ctx.n_w = len(ws)
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, gs, gvx, gvy, gvz, _gcnt):
        saved = ctx.saved_tensors
        send, recv, emask, s, vx, vy, vz, es, evx, evy, evz = saved[:11]
        ws = list(saved[11:11 + ctx.n_w])
        csr = tuple(saved[11 + ctx.n_w:]) or None
        n, vo = s.shape[0], ws[-5].shape[1]
        so = ws[-4].shape[1]
        gs = s.new_zeros((n, so)) if gs is None else gs
        gvx, gvy, gvz = (s.new_zeros((n, vo)) if g is None else g
                         for g in (gvx, gvy, gvz))
        grads = gvp_message_bwd(send, recv, emask, s, vx, vy, vz, es, evx, evy,
                                evz, ws, gs, gvx, gvy, gvz, csr)
        return (None, None, None, *grads[:8], *grads[8])


def gvp_message(send, recv, emask, s, vx, vy, vz, es, evx, evy, evz,
                *weights) -> Tuple[torch.Tensor, ...]:
    """Per-receiver sums of the GVP chain's messages and the edge counts:
    ``(s_sum [N, so], vx_sum, vy_sum, vz_sum [N, vo], cnt [N, 1])``,
    differentiable in the node and edge features and the weights.

    ``send``/``recv`` int32 or int64 ``[E]``, ``emask`` bool ``[E]``,
    ``s [N, S]``, ``vx, vy, vz [N, V]``, ``es [E, SE]``, ``evx, evy, evz
    [E, VE]``, then 6 weights per GVP, all f32.  Every edge's indices must
    lie in ``[0, N)`` on the CPU, masked-in edges' on the card.  CPU tensors
    take the plain versions; CUDA tensors the kernels (contiguous inputs on
    one device; at most 8 GVPs, scalar widths up to 256, vector widths up to
    128, S + 3V and so + 3vo up to 256), launched on the current stream
    without synchronising."""
    return GVPMessage.apply(send, recv, emask, s, vx, vy, vz, es, evx, evy,
                            evz, *weights)


gvp_message.launches = 0
gvp_message.bwd_launches = 0
