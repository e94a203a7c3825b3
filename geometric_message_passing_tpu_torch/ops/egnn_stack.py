"""The whole EGNN stack in one launch per direction (port of
``ops/pallas_egnn_stack.py``'s forward and backward kernels).

``egnn_stack`` is the public wrapper, differentiable in ``h0``, ``pos0`` and
the stacked weights through ``EGNNStack``.  For tensors on the CPU it runs
the plain PyTorch versions, ``egnn_stack_plain`` forward and
``egnn_stack_bwd_plain`` backward; for CUDA tensors it launches the
hand-written kernels ``csrc/egnn_stack.cu`` (K6 forward) and
``csrc/egnn_stack_bwd.cu`` (K6 backward) or raises: it never falls back.
``egnn_stack.launches`` counts the forward calls that launched the forward
kernel, ``egnn_stack.bwd_launches`` the backward calls that launched the
backward kernel.  Each is one launch per call, whatever the layer count.

Function, for ``l = 0 .. L-1`` and ``W = Wall[l]`` (``[7D+18, D]`` rows: the
``[4D+12, D]`` message rows of ``ops.edge.pack_egnn_weights``, then the
update MLP ``U1 [2D, D]; ub1, ug1, uB1; U2 [D, D]; ub2, ug2, uB2``):
  msg_acc, pos_sum, cnt = egnn_message(send, recv, emask, h, pos, W[:4D+12])
  u = relu(LN(cat(h, msg_acc) U1 + ub1)),  upd = relu(LN(u U2 + ub2))
  h <- h + upd,  pos <- pos + pos_sum / max(cnt, 1)
and the result is the last ``(h, pos)``.  The residual is part of the layer:
``residual=False`` raises, as the JAX package's stack asserts.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .edge import (_check_cuda_inputs, _layernorm_cache, _layernorm_bwd,
                   act_edge_ld, bwd_split, egnn_message_bwd_plain,
                   egnn_message_plain, kernel_tile, layernorm, msg_rows,
                   receiver_csr, sender_csr)


def stack_rows(d: int) -> int:
    """Packed rows per layer: the message block (4d+12) and the update MLP
    (3d+6)."""
    return 7 * d + 18


def _unpack_update(w: torch.Tensor, d: int):
    r = msg_rows(d)
    U1 = w[r : r + 2 * d]; r += 2 * d
    ub1, ug1, uB1 = w[r], w[r + 1], w[r + 2]; r += 3
    U2 = w[r : r + d]; r += d
    ub2, ug2, uB2 = w[r], w[r + 1], w[r + 2]
    return U1, ub1, ug1, uB1, U2, ub2, ug2, uB2


def _check_residual(residual: bool) -> None:
    if not residual:
        raise ValueError("egnn_stack implements residual=True only (the "
                         "residual is folded into each layer)")


def _layer_plain(send, recv, emask, h, pos, w):
    d = h.shape[1]
    msg_acc, pos_sum, cnt = egnn_message_plain(send, recv, emask, h, pos,
                                               w[: msg_rows(d)])
    U1, ub1, ug1, uB1, U2, ub2, ug2, uB2 = _unpack_update(w, d)
    u = torch.relu(layernorm(torch.cat([h, msg_acc], dim=-1) @ U1 + ub1,
                             ug1, uB1))
    upd = torch.relu(layernorm(u @ U2 + ub2, ug2, uB2))
    return h + upd, pos + pos_sum / torch.clamp_min(cnt, 1.0)


def egnn_stack_plain(send, recv, emask, h0, pos0, Wall, n_layers: int,
                     residual: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel (the JAX package's
    ``egnn_stack_xla``): ``n_layers`` EGNN layers over ``Wall [L, 7D+18, D]``;
    returns ``(h [N, D], pos [N, 3])``."""
    _check_residual(residual)
    h, pos = h0, pos0
    for l in range(n_layers):
        h, pos = _layer_plain(send, recv, emask, h, pos, Wall[l])
    return h, pos


def egnn_stack_bwd_plain(send, recv, emask, h0, pos0, Wall, n_layers: int,
                         gh, gpos, residual: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the cotangents
    ``(dh0 [N, D], dpos0 [N, 3], dW [L, 7D+18, D])`` of ``egnn_stack`` given
    ``gh [N, D]`` and ``gpos [N, 3]`` at its outputs.  Written out by hand
    per layer, as the kernel runs it: the forward recomputed once with each
    layer's input kept, then layers ``L-1 .. 0``, each the update MLP's
    backward (through ``_layernorm_bwd``) and then ``egnn_message_bwd_plain``
    with the cotangents of the message sum and of the position sum
    (``gpos / max(cnt, 1)``).  Masked-off edges contribute nothing."""
    _check_residual(residual)
    d = h0.shape[1]
    mr = msg_rows(d)
    inputs = [(h0, pos0)]
    for l in range(n_layers - 1):
        inputs.append(_layer_plain(send, recv, emask, *inputs[-1], Wall[l]))
    dh, dpos = gh, gpos
    dW = [None] * n_layers
    for l in reversed(range(n_layers)):
        (h, pos), w = inputs[l], Wall[l]
        msg_acc, _, cnt = egnn_message_plain(send, recv, emask, h, pos, w[:mr])
        U1, ub1, ug1, uB1, U2, ub2, ug2, uB2 = _unpack_update(w, d)
        u_in = torch.cat([h, msg_acc], dim=-1)
        y1, xh1, rstd1 = _layernorm_cache(u_in @ U1 + ub1, ug1, uB1)
        u = torch.relu(y1)
        y2, xh2, rstd2 = _layernorm_cache(u @ U2 + ub2, ug2, uB2)
        dz2, dug2, duB2 = _layernorm_bwd(dh * (y2 > 0), xh2, rstd2, ug2)
        dz1, dug1, duB1 = _layernorm_bwd((dz2 @ U2.T) * (y1 > 0), xh1, rstd1,
                                         ug1)
        du_in = dz1 @ U1.T
        dh_m, dpos_m, dw_m = egnn_message_bwd_plain(
            send, recv, emask, h, pos, w[:mr], du_in[:, d:],
            dpos / torch.clamp_min(cnt, 1.0))
        dW[l] = torch.cat([
            dw_m, u_in.T @ dz1, dz1.sum(dim=0)[None], dug1[None], duB1[None],
            u.T @ dz2, dz2.sum(dim=0)[None], dug2[None], duB2[None]], dim=0)
        dh = dh + du_in[:, :d] + dh_m
        dpos = dpos + dpos_m
    return dh, dpos, torch.stack(dW)


def _check_stack_inputs(send, recv, emask, h0, pos0, Wall, n_layers,
                        gh=None, gpos=None) -> None:
    n, d = h0.shape
    if Wall.dtype != torch.float32 or not Wall.is_contiguous():
        raise ValueError("egnn_stack: Wall must be contiguous float32")
    if Wall.shape != (n_layers, stack_rows(d), d) or n_layers < 1:
        raise ValueError(f"egnn_stack: Wall shape {tuple(Wall.shape)} != "
                         f"({n_layers}, {stack_rows(d)}, {d}) with L >= 1")
    if Wall.device != h0.device:
        raise ValueError(f"egnn_stack: Wall is on {Wall.device}, h0 on {h0.device}")
    # the message rows of one layer stand in for packed_w: same device,
    # type and width rules as the message kernel's
    _check_cuda_inputs(send, recv, emask, h0, pos0, Wall[0, : msg_rows(d)],
                       gh, gpos)


def _launch_fwd(send, recv, emask, h0, pos0, Wall, order, rowptr, bufs,
                stamps=None) -> None:
    """Launch the forward kernel on the current stream; ``bufs`` are
    ``fwd_buffers``' (``h [N, D]`` and ``pos [N, 3]`` receive the result).
    ``stamps`` (int64 ``[2L+1]`` on the card, optional) receives the device
    clock in ns at the start and after each phase (edges, nodes per
    layer)."""
    lib = _build.load("egnn_stack")
    n, d = h0.shape
    dev = h0.device.index if h0.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(h0.device).cuda_stream
    _build.check(lib, lib.gmp_egnn_stack_fwd(
        dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
        emask.data_ptr(), h0.data_ptr(), pos0.data_ptr(), Wall.data_ptr(),
        order.data_ptr(), rowptr.data_ptr(), *(t.data_ptr() for t in bufs),
        None if stamps is None else stamps.data_ptr(),
        n, send.shape[0], d, Wall.shape[0],
        kernel_tile(send.shape[0], d, h0.device), stream), "egnn stack kernel")


def fwd_buffers(n: int, e: int, d: int, device) -> Tuple[torch.Tensor, ...]:
    """The forward kernel's scratch and outputs: per-edge ``msg [E, D]`` and
    ``pos_msg [E, 3]``, the result ``h [N, D]``, ``pos [N, 3]`` and the grid
    barrier's two counters (zeroed)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((e, d), **f32), torch.empty((e, 3), **f32),
            torch.empty((n, d), **f32), torch.empty((n, 3), **f32),
            torch.zeros(2, dtype=torch.int32, device=device))


def _egnn_stack_cuda(send, recv, emask, h0, pos0, Wall, n_layers):
    """K6 forward on the card; also returns the receiver CSR it built."""
    _check_stack_inputs(send, recv, emask, h0, pos0, Wall, n_layers)
    n, d = h0.shape
    csr = receiver_csr(recv, emask, n)
    bufs = fwd_buffers(n, send.shape[0], d, h0.device)
    _launch_fwd(send, recv, emask, h0, pos0, Wall, *csr, bufs)
    egnn_stack.launches += 1
    return (bufs[2], bufs[3]), csr


def act_node_ld(d: int) -> int:
    """Floats of one node's kept update-MLP activations (xhat of its two
    LayerNorms, their rstd, padding to a multiple of 4)."""
    return 2 * d + 4


def bwd_buffers(n: int, e: int, d: int, n_layers: int, device
                ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's scratch and outputs, in the order of its C
    entry point: the layer inputs ``h [L-1, N, D]``, ``pos [L-1, N, 3]``
    (layers 1 .. L-1) and message sums ``[L, N, D]`` of the recomputed
    forward; per edge ``msg [E, D]``, ``pos_msg [E, 3]``; the forward's
    kept activations per layer and edge ``[L, E, 3D+4]`` and per layer and
    node ``[L, N, 2D+4]``; each layer's transposed weight blocks ``[L, 7,
    D, D]``; per node the
    update MLP's weight-gradient operands ``[N, 9D]``, the node cotangent
    ``[N, D]`` and the cotangents of the message and position sums ``[N, D]``,
    ``[N, 3]``; the message backward's per-edge operands ``[E, 15D+4]``,
    ``dh_i``, ``dh_j [E, D]``, ``dpd [E, 3]``; the partial weight gradients
    per slice of ``bwd_split(E)`` edges ``[se, 4D+12, D]`` and nodes
    ``[sn, 3D+6, D]``; the outputs ``dh0 [N, D]``, ``dpos0 [N, 3]``,
    ``dW [L, 7D+18, D]``; the grid barrier's two counters (zeroed)."""
    f32 = dict(dtype=torch.float32, device=device)
    split = bwd_split(e)
    se = max(1, -(-e // split))
    sn = max(1, -(-n // split))
    shapes = ((n_layers - 1, n, d), (n_layers - 1, n, 3), (n_layers, n, d),
              (e, d), (e, 3), (n_layers, e, act_edge_ld(d)),
              (n_layers, n, act_node_ld(d)), (n_layers, 7, d, d),
              (n, 9 * d), (n, d), (n, d), (n, 3),
              (e, 15 * d + 4), (e, d), (e, d), (e, 3),
              (se, msg_rows(d), d), (sn, 3 * d + 6, d),
              (n, d), (n, 3), (n_layers, stack_rows(d), d))
    return (tuple(torch.empty(s, **f32) for s in shapes)
            + (torch.zeros(2, dtype=torch.int32, device=device),))


def _launch_bwd(send, recv, emask, h0, pos0, Wall, gh, gpos, recv_csr,
                send_csr, bufs, stamps=None) -> None:
    """Launch the backward kernel on the current stream; ``bufs`` are
    ``bwd_buffers``' (its ``dh0``, ``dpos0`` and ``dW`` receive the result).
    ``stamps`` (int64 ``[5L+2]`` on the card, optional) receives the device
    clock in ns at the start, after each forward phase (edges, nodes per
    layer), after each backward phase (nodes, edges, sums and weight
    gradients per layer) and at the end."""
    lib = _build.load("egnn_stack_bwd")
    n, d = h0.shape
    dev = h0.device.index if h0.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(h0.device).cuda_stream
    _build.check(lib, lib.gmp_egnn_stack_bwd(
        dev, send.data_ptr(), recv.data_ptr(), int(send.dtype == torch.int64),
        emask.data_ptr(), h0.data_ptr(), pos0.data_ptr(), Wall.data_ptr(),
        gh.data_ptr(), gpos.data_ptr(), *(t.data_ptr() for t in recv_csr),
        *(t.data_ptr() for t in send_csr), *(t.data_ptr() for t in bufs),
        None if stamps is None else stamps.data_ptr(),
        n, send.shape[0], d, Wall.shape[0], bwd_split(send.shape[0]),
        kernel_tile(send.shape[0], d, h0.device), stream),
        "egnn stack backward kernel")


def _egnn_stack_bwd_cuda(send, recv, emask, h0, pos0, Wall, n_layers, gh,
                         gpos, recv_csr=None):
    gh, gpos = gh.contiguous(), gpos.contiguous()
    _check_stack_inputs(send, recv, emask, h0, pos0, Wall, n_layers, gh, gpos)
    n, d = h0.shape
    if recv_csr is None:
        recv_csr = receiver_csr(recv, emask, n)
    bufs = bwd_buffers(n, send.shape[0], d, n_layers, h0.device)
    _launch_bwd(send, recv, emask, h0, pos0, Wall, gh, gpos, recv_csr,
                sender_csr(send, emask, n), bufs)
    egnn_stack.bwd_launches += 1
    return bufs[-4:-1]


def egnn_stack_bwd(send, recv, emask, h0, pos0, Wall, n_layers: int, gh, gpos,
                   residual: bool = True, recv_csr=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dh0, dpos0, dW)`` given the cotangents ``gh [N, D]``, ``gpos
    [N, 3]`` of ``egnn_stack``'s outputs.  CPU tensors take
    ``egnn_stack_bwd_plain``, CUDA tensors the kernel, which reuses
    ``recv_csr`` (``receiver_csr``'s result) when given."""
    _check_residual(residual)
    if h0.device.type == "cpu":
        return egnn_stack_bwd_plain(send, recv, emask, h0, pos0, Wall,
                                    n_layers, gh, gpos)
    if h0.device.type != "cuda":
        raise ValueError(f"egnn_stack: unsupported device {h0.device}")
    return _egnn_stack_bwd_cuda(send, recv, emask, h0, pos0, Wall, n_layers,
                                gh, gpos, recv_csr)


class EGNNStack(torch.autograd.Function):
    """``egnn_stack`` with its hand-written backward (the JAX package's
    ``custom_vjp`` around the stack kernels): gradients to ``h0``, ``pos0``
    and ``Wall``, none to the indices or the mask; a missing cotangent
    counts as zero."""

    @staticmethod
    def forward(ctx, send, recv, emask, h0, pos0, Wall, n_layers):
        csr = ()
        if h0.device.type == "cpu":
            out = egnn_stack_plain(send, recv, emask, h0, pos0, Wall, n_layers)
        elif h0.device.type == "cuda":
            out, csr = _egnn_stack_cuda(send, recv, emask, h0, pos0, Wall,
                                        n_layers)
        else:
            raise ValueError(f"egnn_stack: unsupported device {h0.device}")
        ctx.save_for_backward(send, recv, emask, h0, pos0, Wall, *csr)
        ctx.n_layers = n_layers
        return out

    @staticmethod
    def backward(ctx, gh, gpos):
        send, recv, emask, h0, pos0, Wall, *csr = ctx.saved_tensors
        if gh is None:
            gh = torch.zeros_like(h0)
        if gpos is None:
            gpos = torch.zeros_like(pos0)
        grads = egnn_stack_bwd(send, recv, emask, h0, pos0, Wall,
                               ctx.n_layers, gh, gpos,
                               recv_csr=tuple(csr) or None)
        return (None, None, None) + tuple(grads) + (None,)


def egnn_stack(send, recv, emask, h0, pos0, Wall, n_layers: int,
               residual: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_layers`` EGNN layers, update MLP and residual included, in one
    call: ``(h [N, D], pos [N, 3])``, differentiable in ``h0``, ``pos0`` and
    ``Wall``.

    ``send``/``recv`` int32 or int64 ``[E]``, ``emask`` bool ``[E]``, ``h0``
    f32 ``[N, D]``, ``pos0`` f32 ``[N, 3]``, ``Wall`` f32
    ``[n_layers, 7D+18, D]`` (``FusedEGNNLayer.stack_packed`` per layer).
    Every edge's indices must lie in ``[0, N)`` on the CPU, masked-in edges'
    on the card.  CPU tensors take the plain versions; CUDA tensors take the
    kernels (D a multiple of 16 in [16, 256], contiguous inputs on one
    device), launched on the current stream without synchronising."""
    _check_residual(residual)
    return EGNNStack.apply(send, recv, emask, h0, pos0, Wall, n_layers)


egnn_stack.launches = 0
egnn_stack.bwd_launches = 0
