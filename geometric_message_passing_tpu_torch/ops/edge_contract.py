"""The per-edge weighted CG contraction, TFN's tensor-product stage 2 (port
of ``ops/pallas_tp.py``):

    out[e, w, m] = sum_k T[e, k, m] W[e, k, w]        k = (path, u)

``T [E, K, m]`` is the f32 CG intermediate, ``W [E, K, w]`` the per-edge
weight (f32, or bf16 converted to f32 inside the kernel), ``out [E, w, m]``
f32.

* ``edge_weighted_contract`` is differentiable in ``T`` and ``W``
  (``EdgeContract``): on the card the forward is the hand-written kernel
  ``csrc/edge_contract.cu`` (K7 forward, one launch) and the backward its
  backward kernel (one launch, ``dT`` f32 and ``dW`` in ``W``'s type); on
  the CPU both take the plain versions.  A CUDA tensor launches the kernel
  or raises; nothing falls back.
* ``edge_weighted_contract_plain`` (an einsum) and
  ``edge_weighted_contract_bwd_plain`` are the plain versions.
* ``edge_weighted_contract.launches`` / ``.bwd_launches`` count the
  kernels' launches.

The contraction is exact f32 on the card: the kernels use f32 FMAs, no TF32
and no tensor cores.  ``torch.bmm(W.transpose(1, 2), T)`` computes the same
function in one library call; it is timed beside the kernel by
``chip_smoke.py`` and never called here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

MAX_M = 15   # the kernels' register sums: m = 2l+1 <= 15


def edge_weighted_contract_plain(T: torch.Tensor, W: torch.Tensor
                                 ) -> torch.Tensor:
    """``out[e,w,m] = sum_k T[e,k,m] W[e,k,w]``, with ``W`` cast to ``T``'s
    type first (the JAX package's ``_contract_xla``)."""
    return torch.einsum("...km,...kw->...wm", T,
                        W.to(T.dtype) if W.dtype != T.dtype else W)


def edge_weighted_contract_bwd_plain(T: torch.Tensor, W: torch.Tensor,
                                     dO: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dT, dW)`` of the contraction: ``dT[e,k,m] = sum_w W[e,k,w]
    dO[e,w,m]`` and ``dW[e,k,w] = sum_m T[e,k,m] dO[e,w,m]``, ``dW`` in
    ``W``'s type."""
    Wf = W.to(T.dtype) if W.dtype != T.dtype else W
    dT = torch.einsum("...kw,...wm->...km", Wf, dO)
    dW = torch.einsum("...km,...wm->...kw", T, dO)
    return dT, dW.to(W.dtype)


def _check(T: torch.Tensor, W: torch.Tensor) -> None:
    if T.dtype != torch.float32:
        raise ValueError(f"edge_weighted_contract: T must be float32, got "
                         f"{T.dtype}")
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("edge_weighted_contract: W must be float32 or "
                         f"bfloat16, got {W.dtype}")
    if T.ndim != 3 or W.ndim != 3 or T.shape[:2] != W.shape[:2]:
        raise ValueError("edge_weighted_contract: T [E, K, m] and W [E, K, w] "
                         f"do not match: {tuple(T.shape)}, {tuple(W.shape)}")
    if W.device != T.device:
        raise ValueError(f"edge_weighted_contract: W is on {W.device}, T on "
                         f"{T.device}")
    m = T.shape[2]
    if m > MAX_M or m % 2 == 0:
        raise ValueError(f"edge_weighted_contract: m must be odd and at most "
                         f"{MAX_M} (2l+1), got {m}")
    if T.numel() >= 2**31 or W.numel() >= 2**40:
        raise ValueError("edge_weighted_contract: the tensors are too large")


def _stream_args(t: torch.Tensor):
    dev = t.device.index if t.device.index is not None else \
        torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def launch_fwd(T: torch.Tensor, W: torch.Tensor, out: torch.Tensor) -> None:
    """Launch K7's forward on the current stream into ``out [E, w, m]``.
    No checks and no count: ``edge_weighted_contract`` and the timing code
    call it with contiguous tensors."""
    lib = _build.load("edge_contract")
    e, k, m = T.shape
    dev, stream = _stream_args(T)
    fn = (lib.gmp_contract_fwd if W.dtype == torch.float32
          else lib.gmp_contract_fwd_bf16)
    _build.check(lib, fn(dev, T.data_ptr(), W.data_ptr(), out.data_ptr(),
                         e, k, m, W.shape[2], stream), "edge contract forward")


def launch_bwd(T: torch.Tensor, W: torch.Tensor, dO: torch.Tensor,
               dT: torch.Tensor, dW: torch.Tensor) -> None:
    """Launch K7's backward on the current stream into ``dT [E, K, m]`` and
    ``dW [E, K, w]``.  No checks and no count."""
    lib = _build.load("edge_contract")
    e, k, m = T.shape
    dev, stream = _stream_args(T)
    fn = (lib.gmp_contract_bwd if W.dtype == torch.float32
          else lib.gmp_contract_bwd_bf16)
    _build.check(lib, fn(dev, T.data_ptr(), W.data_ptr(), dO.data_ptr(),
                         dT.data_ptr(), dW.data_ptr(), e, k, m, W.shape[2],
                         stream), "edge contract backward")


def _fwd_cuda(T: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    _check(T, W)
    T, W = T.contiguous(), W.contiguous()
    out = torch.empty((T.shape[0], W.shape[2], T.shape[2]), dtype=torch.float32,
                      device=T.device)
    launch_fwd(T, W, out)
    edge_weighted_contract.launches += 1
    return out


def edge_weighted_contract_bwd(T: torch.Tensor, W: torch.Tensor,
                               dO: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dT, dW)`` of the contraction: K7's backward on the card (one
    launch), the plain version on the CPU."""
    if T.device.type == "cpu":
        return edge_weighted_contract_bwd_plain(T, W, dO)
    if T.device.type != "cuda":
        raise ValueError(f"edge_weighted_contract: unsupported device {T.device}")
    _check(T, W)
    if dO.dtype != torch.float32 or dO.shape != (T.shape[0], W.shape[2],
                                                 T.shape[2]):
        raise ValueError("edge_weighted_contract: dO must be float32 [E, w, m], "
                         f"got {dO.dtype} {tuple(dO.shape)}")
    T, W, dO = T.contiguous(), W.contiguous(), dO.contiguous()
    dT = torch.empty_like(T)
    dW = torch.empty_like(W)
    launch_bwd(T, W, dO, dT, dW)
    edge_weighted_contract.bwd_launches += 1
    return dT, dW


class EdgeContract(torch.autograd.Function):
    @staticmethod
    def forward(ctx, T, W):
        if T.device.type == "cpu":
            out = edge_weighted_contract_plain(T, W)
        elif T.device.type == "cuda":
            out = _fwd_cuda(T, W)
        else:
            raise ValueError(f"edge_weighted_contract: unsupported device "
                             f"{T.device}")
        ctx.save_for_backward(T, W)
        return out

    @staticmethod
    def backward(ctx, dO):
        T, W = ctx.saved_tensors
        dT, dW = edge_weighted_contract_bwd(T, W, dO)
        return dT, dW


def edge_weighted_contract(T: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``out[e,w,m] = sum_k T[e,k,m] W[e,k,w]`` ``[E, w, m]`` f32,
    differentiable in ``T`` and ``W``; K7 on the card (forward and
    backward), the plain versions on the CPU."""
    return EdgeContract.apply(T, W)


edge_weighted_contract.launches = 0
edge_weighted_contract.bwd_launches = 0
