"""The EGNN message pass (port of ``ops/pallas_edge.py``'s forward).

``egnn_message`` is the public wrapper.  For tensors on the CPU it runs
``egnn_message_plain``, the plain PyTorch version; for CUDA tensors it
launches the hand-written kernel ``csrc/egnn_message.cu`` or raises — it
never falls back.  ``egnn_message.launches`` counts the calls that launched
the kernel.

Function (per edge e with receiver i = recv[e], sender j = send[e]):
  x = [h_i, h_j, d],  d = |pos_i - pos_j| (0 where the square is <= 1e-24)
  msg = relu(LN(relu(LN(x W1 + b1)) W2 + b2))
  scale = relu(LN(msg P1 + pb1)) . P2 + pb2
and, over masked-in edges, per receiver: sum of msg [N, D], sum of
(pos_i - pos_j) * scale [N, 3] and the edge count [N, 1].
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from . import _build
from .scatter import segment_sum


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, biased variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


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


def egnn_message_plain(send, recv, emask, h, pos, packed_w
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same math as the JAX package's
    ``egnn_message_xla``)."""
    n, d = h.shape
    (W1, b1, g1, B1, W2, b2, g2, B2,
     P1, pb1, pg1, pB1, P2, pb2) = _unpack(packed_w, d)
    h_j, h_i = h[send], h[recv]
    pos_diff = pos[recv] - pos[send]
    sq = (pos_diff * pos_diff).sum(dim=-1, keepdim=True)
    positive = sq > 1e-24
    dists = torch.where(positive,
                        torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                        torch.zeros_like(sq))
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


def receiver_csr(recv: torch.Tensor, emask: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR of the masked-in edges by receiver: ``order`` lists edge ids
    sorted stably by receiver (masked-off edges sort last), and node ``i``'s
    edges are ``order[rowptr[i]:rowptr[i+1]]``, in ascending edge order.
    Both int64."""
    key = torch.where(emask, recv.long(), torch.full_like(recv, n, dtype=torch.long))
    sorted_key, order = torch.sort(key, stable=True)
    nodes = torch.arange(n + 1, device=recv.device, dtype=torch.long)
    rowptr = torch.searchsorted(sorted_key, nodes)
    return order, rowptr


def _check_cuda_inputs(send, recv, emask, h, pos, packed_w) -> None:
    dev = h.device
    for name, t in (("send", send), ("recv", recv), ("emask", emask),
                    ("h", h), ("pos", pos), ("packed_w", packed_w)):
        if t.device != dev:
            raise ValueError(f"egnn_message: {name} is on {t.device}, h on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"egnn_message: {name} must be contiguous")
    n, d = h.shape
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"egnn_message: D={d} must be a multiple of 16 in [16, 256]")
    for name, t in (("h", h), ("pos", pos), ("packed_w", packed_w)):
        if t.dtype != torch.float32:
            raise ValueError(f"egnn_message: {name} must be float32, got {t.dtype}")
    if pos.shape != (n, 3):
        raise ValueError(f"egnn_message: pos shape {tuple(pos.shape)} != ({n}, 3)")
    if packed_w.shape != (msg_rows(d), d):
        raise ValueError(f"egnn_message: packed_w shape {tuple(packed_w.shape)} "
                         f"!= ({msg_rows(d)}, {d})")
    e = send.shape[0]
    if send.dtype not in (torch.int32, torch.int64) or recv.dtype != send.dtype:
        raise ValueError("egnn_message: send/recv must both be int32 or int64")
    if send.shape != (e,) or recv.shape != (e,) or emask.shape != (e,):
        raise ValueError("egnn_message: send, recv and emask must be [E]")
    if emask.dtype != torch.bool:
        raise ValueError(f"egnn_message: emask must be bool, got {emask.dtype}")
    if n >= 2**31 or e >= 2**31:
        raise ValueError("egnn_message: N and E must be below 2**31")


def _launch_kernels(send, recv, emask, h, pos, packed_w, order, rowptr,
                    msg_e, pos_e, msg_out, pos_out, cnt_out) -> None:
    """Launch the edge and reduce kernels on the current stream into the
    given buffers (per-edge scratch ``msg_e [E, D]``, ``pos_e [E, 3]``;
    outputs ``[N, D]``, ``[N, 3]``, ``[N, 1]``)."""
    lib = _build.load("egnn_message")
    n, d = h.shape
    e = send.shape[0]
    dev = h.device.index if h.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.check(lib, lib.gmp_egnn_edges(
        dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
        emask.data_ptr(), h.data_ptr(), pos.data_ptr(), packed_w.data_ptr(),
        msg_e.data_ptr(), pos_e.data_ptr(), e, d, stream), "egnn edge kernel")
    _build.check(lib, lib.gmp_egnn_reduce(
        dev, order.data_ptr(), rowptr.data_ptr(), msg_e.data_ptr(),
        pos_e.data_ptr(), msg_out.data_ptr(), pos_out.data_ptr(),
        cnt_out.data_ptr(), n, d, stream), "egnn reduce kernel")


def _egnn_message_cuda(send, recv, emask, h, pos, packed_w):
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
    return msg_out, pos_out, cnt_out


def egnn_message(send, recv, emask, h, pos, packed_w
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-receiver sums of EGNN messages, position messages and edge counts:
    ``[N, D]``, ``[N, 3]``, ``[N, 1]``.

    ``send``/``recv`` int32 or int64 ``[E]``, ``emask`` bool ``[E]``,
    ``h`` f32 ``[N, D]``, ``pos`` f32 ``[N, 3]``, ``packed_w`` f32
    ``[4D+12, D]`` (``pack_egnn_weights``).  Masked-in edges must have
    indices in ``[0, N)``.  CPU tensors take the plain version; CUDA tensors
    take the kernel (D a multiple of 16 in [16, 256], contiguous inputs on
    one device), launched on the current stream without synchronising."""
    if h.device.type == "cpu":
        return egnn_message_plain(send, recv, emask, h, pos, packed_w)
    if h.device.type != "cuda":
        raise ValueError(f"egnn_message: unsupported device {h.device}")
    return _egnn_message_cuda(send, recv, emask, h, pos, packed_w)


egnn_message.launches = 0
