"""The per-edge weighted CG contraction, TFN's tensor-product stage 2 (port
of ``ops/pallas_tp.py``):

    out[e, w, m] = sum_k T[e, k, m] W[e, k, w]        k = (path, u)

``T [E, K, m]`` is the f32 CG intermediate, ``W [E, K, w]`` the per-edge
weight (f32, or bf16 converted to f32 inside the kernel), ``out [E, w, m]``
f32.  The hand-written kernels are in ``csrc/edge_contract.cu`` (K7).

* ``edge_weighted_contract(T, W)`` (the JAX package's
  ``edge_weighted_contract``) contracts one group, differentiable in ``T``
  and ``W`` (``EdgeContract``): on the card one launch of the one-group
  kernel forward (``contract_fwd``: a block per edge) and one of its
  backward (``dT`` f32, ``dW`` in ``W``'s type); ``.launches`` /
  ``.bwd_launches`` count them.
* ``edge_weighted_contract_grouped(Ts, Ws)`` contracts a layer's
  output-irrep groups, each ``(T_g, W_g)`` where it lies (no concatenating
  copy of W), differentiable in every ``T_g`` and ``W_g``
  (``EdgeContractGrouped``).  On the card the forward is one launch of the
  grouped kernel (``contract_ring_kernel``: persistent blocks over the
  groups' work list) and the backward one launch of its backward, whatever
  the number of groups; ``.launches`` / ``.bwd_launches`` count them.  The
  grouped kernel reads W in 16-byte vectors: when a group's rows are not
  16-byte multiples (w not a multiple of 4 f32 or 8 bf16 values, or W not
  so aligned) every group takes the one-group kernel instead, one launch
  per group, counted there.
* On the CPU both take the plain versions, ``edge_weighted_contract_plain``
  (an einsum) and ``edge_weighted_contract_bwd_plain``.  A CUDA tensor
  launches a kernel or raises; nothing falls back to the plain versions.
* ``contract_plan`` is the grouped launch's work list: per group its thread
  layout and items, the largest items first.

The contraction is exact f32 on the card: the kernels use f32 FMAs, no TF32
and no tensor cores.  ``torch.bmm(W.transpose(1, 2), T)`` computes one
group in one library call; it is timed beside the kernel by
``chip_smoke.py`` and never called here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

MAX_M = 15        # the kernels' register sums: m = 2l+1 <= 15
MAX_GROUPS = 16   # groups in one launch (csrc/edge_contract.cu kMaxGroups)
THREADS = 256     # threads per block
ROWS_PER_THREAD = 16   # W rows each thread streams per edge, where K allows
CHUNK_ROWS = 4    # rows per thread per chunk of the W ring (kRows)
STAGES = 3        # chunks in the W ring (kStages)
SMEM_MAX = 227 * 1024  # dynamic shared memory a block can use
SMEM_ITEM = 16384      # floats of an item's shared arrays that edges fill


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


def contract_plan(shapes: Sequence[Tuple[int, int, int, int]], vec: int
                  ) -> List[dict]:
    """The work list of one grouped launch.  ``shapes``: ``(E, K, m, w)``
    per group; ``vec``: W values per 16-byte load (4 for f32, 8 for bf16
    W).

    A group's W rows are cut into ``cols = w / vec`` vector columns; a
    sub-block of ``tpi = ks * cols`` threads takes one edge, thread ``(s,
    c)`` the column ``c`` of the rows ``s, s + ks, ...``; a block of
    ``THREADS`` holds ``epb`` sub-blocks, so an item is ``epb`` consecutive
    edges: as many as fit the threads and whose shared arrays (T, dO and
    the partial sums, ``edge_floats``) fit ``SMEM_ITEM`` floats, at least
    one.  ``ks``, at most ``ceil(K / ROWS_PER_THREAD)`` (so a thread
    streams at least that many rows where K allows), is the one that keeps
    the most threads busy, the larger on a tie.  Returns one dict per group
    (``group``: its index in ``shapes``; ``cols``, ``ks``, ``tpi``,
    ``epb``, ``items``, ``item0``) in launch order: the largest W block per
    item first (ties keep group order), the items numbered consecutively
    from 0."""
    plan = []
    for i, (e, k, m, w) in enumerate(shapes):
        if w % vec:
            raise ValueError(f"contract_plan: w {w} is not a multiple of {vec}")
        cols = w // vec
        if not 1 <= cols <= THREADS:
            raise ValueError(f"edge_weighted_contract: w {w} gives {cols} "
                             f"vector columns; the kernel takes 1 to {THREADS}")
        hi = max(1, min(THREADS // cols, -(-k // ROWS_PER_THREAD)))

        def edges_per_block(ks):
            fit = SMEM_ITEM // edge_floats(k, m, w, ks, cols)
            return max(1, min(THREADS // (ks * cols), fit))

        ks = max(range(1, hi + 1),
                 key=lambda x: (edges_per_block(x) * x * cols, x))
        epb = edges_per_block(ks)
        plan.append(dict(group=i, cols=cols, ks=ks, tpi=ks * cols, epb=epb,
                         items=-(-e // epb), block=epb * k * w))
    plan.sort(key=lambda p: -p["block"])
    item0 = 0
    for p in plan:
        p["item0"] = item0
        item0 += p["items"]
    return plan


def _work_floats(k, m, w, ks, cols, backward: bool) -> int:
    """Per edge: the ks slices' partial sums (forward) or one chunk's dT
    partials, a padded column each (backward)."""
    return cols * (ks * CHUNK_ROWS * m + 1) if backward else ks * w * m


def edge_floats(k: int, m: int, w: int, ks: int, cols: int,
                backward: bool = None) -> int:
    """Shared floats one edge of an item needs (``csrc/edge_contract.cu``):
    two buffers of its T (and, backward, of its dO) and its partial sums;
    the larger of the two directions when ``backward`` is None."""
    fwd = 2 * k * m + _work_floats(k, m, w, ks, cols, False)
    bwd = 2 * (k * m + w * m) + _work_floats(k, m, w, ks, cols, True)
    return {None: max(fwd, bwd), False: fwd, True: bwd}[backward]


def smem_layout(plan: Sequence[dict], shapes, backward: bool,
                wsize: int) -> Tuple[int, ...]:
    """``(bytes, slot, fofs, tmax, omax)``: the dynamic shared memory of a
    grouped launch, the size of a W ring slot, the byte offset of the shared
    floats and the floats of one T and one dO buffer.  The ring of
    ``STAGES`` slots comes first, each the largest chunk (``epb`` edges x
    ``ks * CHUNK_ROWS`` rows of ``w`` values of ``wsize`` bytes) rounded to
    128 bytes, then its mbarriers, then the floats: two T buffers, two dO
    buffers (backward) and the partial sums of the largest item."""
    groups = [(p, shapes[p["group"]]) for p in plan]
    tmax = max(p["epb"] * k * m for p, (_, k, m, _) in groups)
    omax = max(p["epb"] * w * m for p, (_, _, m, w) in groups) \
        if backward else 0
    work = max(p["epb"] * _work_floats(k, m, w, p["ks"], p["cols"], backward)
               for p, (_, k, m, w) in groups)
    slot = max(p["epb"] * p["ks"] * CHUNK_ROWS * w * wsize
               for p, (_, _, _, w) in groups)
    slot = -(-slot // 128) * 128
    fofs = STAGES * slot + 128
    return fofs + 4 * (2 * (tmax + omax) + work), slot, fofs, tmax, omax


class _Layout(NamedTuple):
    """A grouped launch's shape-only part (``_layout``)."""
    order: tuple      # the live groups in launch order
    ints: ctypes.Array
    items: int
    smem: Tuple[int, ...]   # smem_layout's (bytes, slot, fofs, tmax, omax)
    vec: int
    mmax: int


@functools.lru_cache(maxsize=256)
def _layout(key: tuple, backward: bool, wsize: int) -> Optional[_Layout]:
    """Plan, shared-memory layout and shape table of a grouped launch;
    ``key``: per live group ``(E, K, m, w, W's edge stride, W 16-byte
    aligned)``.  None when a group's rows are not 16-byte vectors.  Cached:
    a model calls the same shapes again and again."""
    vec = 16 // wsize
    if not all(w % vec == 0 and stride % vec == 0 and aligned
               for _, _, _, w, stride, aligned in key):
        return None
    shapes = [g[:4] for g in key]
    plan = contract_plan(shapes, vec)
    smem = smem_layout(plan, shapes, backward, wsize)
    if smem[0] > SMEM_MAX:
        raise ValueError(f"edge_weighted_contract: a group needs {smem[0]} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    ints = []
    for p in plan:
        e, k, m, w, stride, _ = key[p["group"]]
        ints += [e, stride, k, m, w, p["cols"], p["ks"], p["tpi"], p["epb"],
                 p["item0"]]
    return _Layout(tuple(p["group"] for p in plan),
                   (ctypes.c_int64 * len(ints))(*ints),
                   plan[-1]["item0"] + plan[-1]["items"], smem, vec,
                   max(g[2] for g in key))


def _w_rows(W: torch.Tensor) -> torch.Tensor:
    """``W`` itself if its rows are contiguous within each edge (any edge
    stride), else a contiguous copy."""
    if W.stride(2) == 1 and (W.shape[1] <= 1 or W.stride(1) == W.shape[2]):
        return W
    return W.contiguous()


def _stream_args(t: torch.Tensor):
    dev = t.device.index if t.device.index is not None else \
        torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


# ---- one group a launch ----

def launch_fwd(T: torch.Tensor, W: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the one-group forward kernel on the current stream into
    ``out [E, w, m]``.  No checks and no count: ``edge_weighted_contract``
    and the timing code call it with contiguous tensors."""
    lib = _build.load("edge_contract")
    e, k, m = T.shape
    dev, stream = _stream_args(T)
    fn = (lib.gmp_contract_fwd if W.dtype == torch.float32
          else lib.gmp_contract_fwd_bf16)
    _build.check(lib, fn(dev, T.data_ptr(), W.data_ptr(), out.data_ptr(),
                         e, k, m, W.shape[2], stream), "edge contract forward")


def launch_bwd(T: torch.Tensor, W: torch.Tensor, dO: torch.Tensor,
               dT: torch.Tensor, dW: torch.Tensor) -> None:
    """Launch the one-group backward kernel on the current stream into
    ``dT [E, K, m]`` and ``dW [E, K, w]``.  No checks and no count."""
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
    """``(dT, dW)`` of the contraction: K7's one-group backward on the card
    (one launch), the plain version on the CPU."""
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
    differentiable in ``T`` and ``W``; K7's one-group kernels on the card
    (forward and backward), the plain versions on the CPU."""
    return EdgeContract.apply(T, W)


edge_weighted_contract.launches = 0
edge_weighted_contract.bwd_launches = 0


# ---- all groups of a layer in one launch ----

def _grouped_layout(Ts, Ws, backward: bool):
    """``(live, layout)``: the groups with work (E, K and w all positive)
    and their grouped launch's ``_layout`` (None when there are none or
    their W rows are not 16-byte vectors)."""
    live = [i for i, (T, W) in enumerate(zip(Ts, Ws))
            if T.shape[0] and T.shape[1] and W.shape[2]]
    if not live:
        return live, None
    key = tuple((*Ts[i].shape, Ws[i].shape[2], Ws[i].stride(0),
                 Ws[i].data_ptr() % 16 == 0) for i in live)
    return live, _layout(key, backward, Ws[live[0]].element_size())


def _launch_grouped(Ts, Ws, live, lay: _Layout, backward: bool, outs=None,
                    dOs=None, dTs=None, dWs=None) -> None:
    """One launch of the grouped kernel over the ``live`` groups."""
    ptrs = []
    for g in lay.order:
        i = live[g]
        ptrs += [Ts[i].data_ptr(), Ws[i].data_ptr(),
                 outs[i].data_ptr() if outs is not None else 0,
                 dOs[i].data_ptr() if dOs is not None else 0,
                 dTs[i].data_ptr() if dTs is not None else 0,
                 dWs[i].data_ptr() if dWs is not None else 0]
    parr = (ctypes.c_uint64 * len(ptrs))(*ptrs)
    lib = _build.load("edge_contract")
    dev, stream = _stream_args(Ts[live[0]])
    _build.check(lib, lib.gmp_contract_grouped(
        dev, int(backward), len(lay.order), ctypes.addressof(parr),
        ctypes.addressof(lay.ints), lay.items, *lay.smem,
        int(Ws[live[0]].dtype == torch.bfloat16), lay.vec, lay.mmax, stream),
        "edge contract grouped " + ("backward" if backward else "forward"))


def _grouped_or_raise(Ts, Ws, backward: bool):
    live, lay = _grouped_layout(Ts, Ws, backward)
    if live and lay is None:
        raise ValueError("edge_weighted_contract: the grouped kernel needs W "
                         "rows of 16-byte vectors")
    return live, lay


def launch_grouped_fwd(Ts, Ws, outs) -> None:
    """Launch the grouped forward kernel over the groups on the current
    stream into ``outs`` (``[E, w, m]`` each).  No checks and no count: the
    timing code calls it with contiguous T and W rows of 16-byte vectors,
    contiguous per edge."""
    live, lay = _grouped_or_raise(Ts, Ws, False)
    if live:
        _launch_grouped(Ts, Ws, live, lay, False, outs=outs)


def launch_grouped_bwd(Ts, Ws, dOs, dTs, dWs) -> None:
    """Launch the grouped backward kernel over the groups on the current
    stream into ``dTs`` (``[E, K, m]``) and ``dWs`` (``[E, K, w]``,
    contiguous).  No checks and no count."""
    live, lay = _grouped_or_raise(Ts, Ws, True)
    if live:
        _launch_grouped(Ts, Ws, live, lay, True, dOs=dOs, dTs=dTs, dWs=dWs)


def _check_groups(Ts, Ws) -> None:
    if len(Ts) != len(Ws) or not 1 <= len(Ts) <= MAX_GROUPS:
        raise ValueError(f"edge_weighted_contract: {len(Ts)} T and {len(Ws)} "
                         f"W; the kernel takes 1 to {MAX_GROUPS} groups")
    for T, W in zip(Ts, Ws):
        _check(T, W)
        if T.device != Ts[0].device:
            raise ValueError("edge_weighted_contract: the groups lie on "
                             f"{T.device} and {Ts[0].device}")
        if W.dtype != Ws[0].dtype:
            raise ValueError("edge_weighted_contract: the groups' W are "
                             f"{W.dtype} and {Ws[0].dtype}")


def _fwd(Ts, Ws) -> List[torch.Tensor]:
    dev = Ts[0].device
    if dev.type == "cpu":
        return [edge_weighted_contract_plain(T, W) for T, W in zip(Ts, Ws)]
    if dev.type != "cuda":
        raise ValueError(f"edge_weighted_contract: unsupported device {dev}")
    _check_groups(Ts, Ws)
    Ts = [T.contiguous() for T in Ts]
    Ws = [_w_rows(W) for W in Ws]
    outs = [(torch.empty if T.shape[1] else torch.zeros)(
        (T.shape[0], W.shape[2], T.shape[2]), dtype=torch.float32,
        device=dev) for T, W in zip(Ts, Ws)]
    live, lay = _grouped_layout(Ts, Ws, False)
    if lay is not None:
        _launch_grouped(Ts, Ws, live, lay, False, outs=outs)
        edge_weighted_contract_grouped.launches += 1
    else:   # W rows not 16-byte vectors: the one-group kernel per group
        for i in live:
            launch_fwd(Ts[i], Ws[i].contiguous(), outs[i])
            edge_weighted_contract.launches += 1
    return outs


def edge_weighted_contract_grouped_bwd(Ts: Sequence[torch.Tensor],
                                       Ws: Sequence[torch.Tensor],
                                       dOs: Sequence[torch.Tensor]
                                       ) -> Tuple[list, list]:
    """``(dTs, dWs)`` of the grouped contraction: K7's grouped backward on
    the card (one launch for all groups; the one-group kernel per group when
    W's rows are not 16-byte vectors), the plain version on the CPU."""
    dev = Ts[0].device
    if dev.type == "cpu":
        grads = [edge_weighted_contract_bwd_plain(T, W, dO)
                 for T, W, dO in zip(Ts, Ws, dOs)]
        return [g[0] for g in grads], [g[1] for g in grads]
    if dev.type != "cuda":
        raise ValueError(f"edge_weighted_contract: unsupported device {dev}")
    _check_groups(Ts, Ws)
    if len(dOs) != len(Ts):
        raise ValueError(f"edge_weighted_contract: {len(dOs)} cotangents for "
                         f"{len(Ts)} groups")
    for T, W, dO in zip(Ts, Ws, dOs):
        if dO.dtype != torch.float32 or dO.shape != (T.shape[0], W.shape[2],
                                                     T.shape[2]):
            raise ValueError("edge_weighted_contract: dO must be float32 "
                             f"[E, w, m], got {dO.dtype} {tuple(dO.shape)}")
    Ts = [T.contiguous() for T in Ts]
    Ws = [_w_rows(W) for W in Ws]
    dOs = [dO.contiguous() for dO in dOs]
    dTs = [(torch.empty if W.shape[2] else torch.zeros)(
        T.shape, dtype=torch.float32, device=dev) for T, W in zip(Ts, Ws)]
    dWs = [torch.empty(W.shape, dtype=W.dtype, device=dev) for W in Ws]
    live, lay = _grouped_layout(Ts, Ws, True)
    if lay is not None:
        _launch_grouped(Ts, Ws, live, lay, True, dOs=dOs, dTs=dTs, dWs=dWs)
        edge_weighted_contract_grouped.bwd_launches += 1
    else:
        for i in live:
            launch_bwd(Ts[i], Ws[i].contiguous(), dOs[i], dTs[i], dWs[i])
            edge_weighted_contract.bwd_launches += 1
    return dTs, dWs


class EdgeContractGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *tensors):
        Ts, Ws = tensors[:n], tensors[n:]
        outs = _fwd(Ts, Ws)
        ctx.save_for_backward(*Ts, *Ws)
        ctx.n = n
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dOs):
        saved = ctx.saved_tensors
        Ts, Ws = saved[:ctx.n], saved[ctx.n:]
        dOs = [torch.zeros((T.shape[0], W.shape[2], T.shape[2]),
                           dtype=torch.float32, device=T.device)
               if d is None else d for d, T, W in zip(dOs, Ts, Ws)]
        dTs, dWs = edge_weighted_contract_grouped_bwd(Ts, Ws, dOs)
        return (None, *dTs, *dWs)


def edge_weighted_contract_grouped(Ts: Sequence[torch.Tensor],
                                   Ws: Sequence[torch.Tensor]
                                   ) -> List[torch.Tensor]:
    """``[out_g[e,w,m] = sum_k T_g[e,k,m] W_g[e,k,w]]`` ``[E, w_g, m_g]``
    f32 per group, differentiable in every ``T_g`` and ``W_g``: one K7
    launch forward and one backward on the card, whatever the number of
    groups (at most 16, all W of one type), when every W's rows are
    16-byte vectors (else the one-group kernel per group); the plain
    versions on the CPU.  Each ``W_g`` is read where it lies when its rows
    are contiguous within an edge (a slice of a wider head output is)."""
    Ts, Ws = list(Ts), list(Ws)
    if len(Ts) != len(Ws) or not Ts:
        raise ValueError(f"edge_weighted_contract: {len(Ts)} T and {len(Ws)} W")
    return list(EdgeContractGrouped.apply(len(Ts), *Ts, *Ws))


edge_weighted_contract_grouped.launches = 0
edge_weighted_contract_grouped.bwd_launches = 0
